#!/usr/bin/env python3
"""chip_smoke.py's [gen1-lc-batch] cell (or, with --cell gen1-batch, its
[gen1-batch] cell) on its own, with what holds each step: the wall time
per batched step, the device's kernel time per step, the host's time to
issue one step and the host syncs.

    python3 cityflow_tpu_torch/tools/time_lcb_cell.py [--root DIR] \
        [--cell gen1-lc-batch|gen1-batch] [--batch 128] [--steps 40] \
        [--windows 2] [--out FILE]

The [gen1-batch] cell: config_30x30.json in fast mode, one Engine run
past the timed steps at one env (its pool then covers them), its state
after GEN1B_WARMUP steps in that pool copied into the batch.

The cell: config_30x30_lc.json under DURATION, one exact Engine warmed
1960 steps at one env, its state cast to float32 in a pool of 131072
slots and copied into a batch of 128, then `windows` windows of `steps`
timed batched steps (parallel/batch.make_batched_step, which steps the
state forward and never again from a kept one; each window's wall time,
one synchronize at its end; the first window is chip_smoke's) and the
peak device memory allocated over them.
Then 3 steps each issued after a synchronize: the host's time to return
from the step call (the launches queue; the device runs behind), and 3
steps under torch.profiler: the device's kernel time per step, the
kernels launched per step, the host syncs per step
(aten::_local_scalar_dense: a value read back to the host), the CUDA
runtime's allocation, copy and synchronize calls per step, and the TOP
kernels by their own device time and aten ops by the device time of what
they launched (ms and calls per step).

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
GEN1B_WARMUP = 300
TOP = 15            # profiler rows kept, by device time


def warm_batch(root, cell, batch, horizon):
    """(net, cfg, spawn, batched state, warm-up seconds) of the cell."""
    import dataclasses
    import torch
    from cityflow_tpu_torch.carry import (
        net_tensors, sim_state_from_numpy, sim_state_to_numpy)
    from cityflow_tpu_torch.core.state import pad_state
    from cityflow_tpu_torch.engine import Engine
    from cityflow_tpu_torch.parallel.batch import init_batch_state
    from cityflow_tpu_torch.tools.scenario import prepare
    t0 = time.time()
    if cell == "gen1-batch":
        eng = Engine(prepare(os.path.join(root, "benchmarks",
                                          "config_30x30.json")),
                     exact=False, backend="gen1",
                     spawn_horizon=GEN1B_WARMUP + horizon)
        for i in range(GEN1B_WARMUP + horizon):
            eng.next_step()
            if i + 1 == GEN1B_WARMUP:
                snap = eng.state
        cfg, net, spawn = eng.cfg, eng._net_dev, eng._spawn_dev
        stb = init_batch_state(cfg, pad_state(snap, cfg.max_vehicles), batch)
        torch.cuda.synchronize()
        return net, cfg, spawn, stb, time.time() - t0
    cfg_path = prepare(os.path.join(root, "benchmarks",
                                    "config_30x30_lc.json"),
                       name="config_30x30_lc_duration",
                       routerType="DURATION")
    eng = Engine(cfg_path, exact=True, backend="gen1",
                 spawn_horizon=WARMUP + horizon)
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
    return net, cfg, spawn, init_batch_state(cfg, one, batch), warm_s


def run(root, batch, steps, windows, cell="gen1-lc-batch"):
    import torch
    import cityflow_tpu_torch
    from cityflow_tpu_torch.parallel.batch import make_batched_step
    nprobe = 3
    net, cfg, spawn, stb, warm_s = warm_batch(
        root, cell, batch, windows * steps + 2 * nprobe + 16)
    step_b = make_batched_step(net, cfg, with_obs=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wall_ms = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            stb = step_b(stb, spawn)[0]
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3 / steps)
    peak = torch.cuda.max_memory_allocated()
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
    kernels = sum(e.count for e in ka if e.device_type == cuda) / nprobe
    # where the device time goes: the kernels by their own time, and the
    # host ops by the device time of what they launched
    top = lambda evs, t: [
        dict(op=e.key[:120], ms=round(t(e) / 1e3 / nprobe, 4),
             calls=e.count / nprobe)
        for e in sorted(evs, key=t, reverse=True)[:TOP]]
    incl = lambda e: (getattr(e, "device_time_total", None)
                      or getattr(e, "cuda_time_total", 0))
    top_kernels = top([e for e in ka if e.device_type == cuda], dev_t)
    top_ops = top([e for e in ka if e.device_type != cuda
                   and e.key.startswith("aten::")], incl)
    runtime = {e.key: e.count / nprobe for e in ka
               if e.key.startswith("cuda") and any(
                   w in e.key for w in ("Malloc", "Free", "Memcpy",
                                        "Synchronize"))}
    return dict(package=os.path.dirname(cityflow_tpu_torch.__file__),
                cell=cell, batch=batch, steps=steps, ms_per_step=wall_ms,
                device_ms_per_step=device_ms,
                device_busy=device_ms / wall_ms[0],
                host_issue_ms=issue_ms,
                host_syncs_per_step=count("aten::_local_scalar_dense"),
                runtime_calls_per_step=runtime, vehicles_per_env=veh,
                pool=cfg.max_vehicles, overflow=overflow, warm_s=warm_s,
                peak_bytes=peak, kernels_per_step=kernels,
                top_kernels=top_kernels, top_ops=top_ops)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--cell", default="gen1-lc-batch",
                    choices=("gen1-lc-batch", "gen1-batch"))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_lcb_cell: no CUDA device")
    res = run(args.root, args.batch, args.steps, args.windows, args.cell)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
