#!/usr/bin/env python3
"""chip_smoke.py's [gen1-lc-batch] cell on its own, with what holds each
step: the wall time per batched step, the device's kernel time per step,
the host's time to issue one step and the host syncs.

    python3 cityflow_tpu_torch/tools/time_lcb_cell.py [--root DIR] \
        [--batch 128] [--steps 40] [--windows 2] [--out FILE]

The cell: config_30x30_lc.json under DURATION, one exact Engine warmed
1960 steps at one env, its state cast to float32 in a pool of 131072
slots and copied into a batch of 128, then `windows` windows of `steps`
timed batched steps (parallel/batch.make_batched_step; each window's
wall time, one synchronize at its end; the first window is chip_smoke's).
Then 3 steps each issued after a synchronize: the host's time to return
from the step call (the launches queue; the device runs behind), and 3
steps under torch.profiler: the device's kernel time per step, the host
syncs per step (aten::_local_scalar_dense: a value read back to the
host) and the CUDA runtime's allocation, copy and synchronize calls per
step.

`--root` is the checkout whose cityflow_tpu_torch is imported (default:
the one that holds this file), so that two commits are compared with one
script: run it by path, once per checkout, in turns (A B B A) in one
call. Prints one JSON object as its last line.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WARMUP = 1960
POOL = 131072


def run(root, batch, steps, windows):
    import dataclasses
    import torch
    import cityflow_tpu_torch
    from cityflow_tpu_torch.carry import (
        net_tensors, sim_state_from_numpy, sim_state_to_numpy)
    from cityflow_tpu_torch.core.state import pad_state
    from cityflow_tpu_torch.engine import Engine
    from cityflow_tpu_torch.parallel.batch import (
        init_batch_state, make_batched_step)
    from cityflow_tpu_torch.tools.scenario import prepare
    cfg_path = prepare(os.path.join(root, "benchmarks",
                                    "config_30x30_lc.json"),
                       name="config_30x30_lc_duration",
                       routerType="DURATION")
    nprobe = 3
    t0 = time.time()
    eng = Engine(cfg_path, exact=True, backend="gen1",
                 spawn_horizon=WARMUP + windows * steps + 2 * nprobe + 16)
    for _ in range(WARMUP):
        eng.next_step()
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    pool = max(POOL, eng.cfg.max_vehicles)
    cfg = dataclasses.replace(eng.cfg, exact=False, max_vehicles=pool)
    dev = eng.device
    net = net_tensors(eng.net, torch.float32, dev)
    spawn = eng._spawn_dev
    one = sim_state_from_numpy(sim_state_to_numpy(
        pad_state(eng.state, pool)), dev, torch.float32)
    del eng
    stb = init_batch_state(cfg, one, batch)
    del one
    step_b = make_batched_step(net, cfg, with_obs=False)
    wall_ms = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            stb = step_b(stb, spawn)[0]
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3 / steps)
    overflow = int(stb.overflow.max())
    veh = int(stb.running[0].sum())
    issue_ms = []
    for _ in range(nprobe):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stb = step_b(stb, spawn)[0]
        issue_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(nprobe):
            stb = step_b(stb, spawn)[0]
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_t = lambda e: (getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0))
    ka = prof.key_averages()
    device_ms = sum(dev_t(e) for e in ka if e.device_type == cuda) \
        / 1e3 / nprobe
    count = lambda k: sum(e.count for e in ka if e.key == k) / nprobe
    runtime = {e.key: e.count / nprobe for e in ka
               if e.key.startswith("cuda") and any(
                   w in e.key for w in ("Malloc", "Free", "Memcpy",
                                        "Synchronize"))}
    return dict(package=os.path.dirname(cityflow_tpu_torch.__file__),
                batch=batch, steps=steps, ms_per_step=wall_ms,
                device_ms_per_step=device_ms,
                device_busy=device_ms / wall_ms[0],
                host_issue_ms=issue_ms,
                host_syncs_per_step=count("aten::_local_scalar_dense"),
                runtime_calls_per_step=runtime, vehicles_per_env=veh,
                pool=pool, overflow=overflow, warm_s=warm_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_lcb_cell: no CUDA device")
    res = run(args.root, args.batch, args.steps, args.windows)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
