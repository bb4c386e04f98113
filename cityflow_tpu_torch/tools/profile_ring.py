#!/usr/bin/env python3
"""Where the batched ring step's device time goes, by operator.

Runs the 30x30 main path (p1 + p2, B envs) on the card, warms up, times
a few steps without the profiler (wall clock, synchronised), then records
as many under torch.profiler and prints the operators and kernels by self
device time, plus the device's busy share: kernel time per step over the
unprofiled wall time per step.

    python -m cityflow_tpu_torch.tools.profile_ring \
        [--config benchmarks/config_30x30.json] [--batch 128] [--steps 3] \
        [--out profile.txt]

The config's roadnet and flow are staged under the checkout's build/
(tools/scenario.py).
"""

import argparse
import os
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="benchmarks/config_30x30.json")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rows", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from cityflow_tpu_torch import ring_sim
    from cityflow_tpu_torch.compiler.net import compile_scenario
    from cityflow_tpu_torch.core.ring import (
        batch_ring_state, ring_step_p1_batched, ring_step_p2_batched)
    from cityflow_tpu_torch.tools.scenario import prepare

    sim = ring_sim.build_sim(compile_scenario(prepare(args.config)),
                             horizon=args.warmup + args.steps + 8, sl=40)
    st = batch_ring_state(sim.state, args.batch)

    def step(s):
        s, m = ring_step_p1_batched(sim.tables, sim.cfg, s, sim.q)
        return ring_step_p2_batched(sim.tables, sim.cfg, s, m)

    for _ in range(args.warmup):
        st = step(st)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(args.steps):
        st = step(st)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            st = step(st)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev_ms = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0)
                 for e in ka if e.device_type == cuda) / 1e3 / args.steps
    table = ka.table(sort_by="self_cuda_time_total", row_limit=args.rows)
    head = (f"card: {torch.cuda.get_device_name(0)}; B={args.batch}; "
            f"wall {wall_ms:.2f} ms/step (unprofiled, {args.steps} steps); "
            f"kernel time {dev_ms:.2f} ms/step; device busy "
            f"{100 * dev_ms / wall_ms:.1f}% of wall")
    print(head)
    print(table)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(head + "\n" + table + "\n")


if __name__ == "__main__":
    main()
