#!/usr/bin/env python3
"""Run a scenario through the port's Engine and report the wall time: the
reference's tools/debug/simple_run (`--configFile -s steps -t threads`,
$DATADIR prefix), on the CUDA card by default; the exact (float64) gen-1
Engine, or with --fast Engine(config, exact=False): the ring where the
scenario fits its layout, gen-1 fast mode (float32) elsewhere.

    python3 -m cityflow_tpu_torch.tools.simple_run --configFile cfg.json -s 100
    python3 -m cityflow_tpu_torch.tools.simple_run ... --fast
    python3 -m cityflow_tpu_torch.tools.simple_run ... --cpu   # plain versions
"""

import argparse
import os
import time


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configFile", default="examples/config.json")
    ap.add_argument("-s", "--steps", type=int, default=1000)
    ap.add_argument("-t", "--threads", type=int, default=1,
                    help="accepted as the reference does; results do not "
                         "depend on it")
    ap.add_argument("--exact", action="store_true", default=True,
                    help="the exact (float64) gen-1 Engine (the default)")
    ap.add_argument("--fast", dest="exact", action="store_false",
                    help="Engine(config, exact=False)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (every kernel's plain PyTorch "
                         "version) instead of the card")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    from cityflow_tpu_torch.engine import Engine
    config = os.environ.get("DATADIR", "") + args.configFile
    eng = Engine(config, thread_num=args.threads, exact=args.exact,
                 device="cpu" if args.cpu else None)
    t0 = time.time()
    for _ in range(args.steps):
        eng.next_step()
    if eng.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    dt = time.time() - t0
    print(f"Total Step: {args.steps}")
    print(f"Total Time: {dt:.4f}")
    print(f"steps/s: {args.steps / dt:.1f}  "
          f"vehicles: {eng.get_vehicle_count()}  "
          f"avg travel time: {eng.get_average_travel_time():.2f}")
    return eng


if __name__ == "__main__":
    main()
