#!/usr/bin/env python3
"""chip_smoke.py's [main] (or, with --cell mixed, its [mixed]; with --cell
engine, its [ring-engine]) ring cell on its own: the wall time per step
and the device's kernel time per step.

    python3 cityflow_tpu_torch/tools/time_ring_cell.py [--root DIR] \
        [--cell main|mixed|engine] [--batch 128] [--steps 40] \
        [--windows 2] [--out FILE]

The cell is chip_smoke's: benchmarks/config_30x30.json (for [mixed] with
flow i's vehicle replaced by template i mod 3 of
tests/fixtures/flow_2x2_mixed.json), staged under build/scenarios/, lane
slots 40 ([main]) or build_sim's ([mixed]), WARMUP steps of one env
copied into a batch of `batch` (as tools/bench.run_ring warms up), then
`windows` windows of `steps` timed batched steps (p1 + p2; one
synchronize at each window's end; the first window is chip_smoke's),
then 3 steps under torch.profiler: the device's kernel time per step.
engine: Engine(exact=False) on benchmarks/config_30x30.json (the ring at
one env; --batch is ignored), RING_ENGINE_WARMUP (300) steps of
next_step(), then the same windows and profile, without getters.

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
WARMUP = 8
RING_ENGINE_WARMUP = 300


def run(root, cell, batch, steps, windows):
    import torch
    import cityflow_tpu_torch
    from cityflow_tpu_torch import ring_sim
    from cityflow_tpu_torch.compiler.net import compile_scenario
    from cityflow_tpu_torch.core.ring import (
        batch_ring_state, ring_step_p1_batched, ring_step_p2_batched)
    from cityflow_tpu_torch.tools.scenario import mixed_templates, prepare
    cfg = os.path.join(root, "benchmarks", "config_30x30.json")
    if cell == "mixed":
        cfg = prepare(cfg, name="config_30x30_mixed",
                      templates=mixed_templates(os.path.join(
                          root, "tests", "fixtures", "flow_2x2_mixed.json")))
    else:
        cfg = prepare(cfg)
    nprobe = 3
    t0 = time.time()
    if cell == "engine":
        from cityflow_tpu_torch.engine import Engine
        eng = Engine(cfg, exact=False, spawn_horizon=RING_ENGINE_WARMUP
                     + windows * steps + nprobe + 16)
        for _ in range(RING_ENGINE_WARMUP):
            eng.next_step()
        st = None

        def step(_):
            eng.next_step()
    else:
        sim = ring_sim.build_sim(
            compile_scenario(cfg),
            horizon=WARMUP + windows * steps + nprobe + 16,
            sl=40 if cell == "main" else None)

        def step(s):
            s, m = ring_step_p1_batched(sim.tables, sim.cfg, s, sim.q)
            return ring_step_p2_batched(sim.tables, sim.cfg, s, m)
        # tools/bench.run_ring's warm-up: one env, copied into the batch,
        # whose first batched step is the warm-up's last
        one = batch_ring_state(sim.state, 1)
        for _ in range(WARMUP - 1):
            one = step(one)
        st = step(batch_ring_state(one.map(lambda x: x[..., 0]), batch))
        del one
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    wall_ms = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            st = step(st)
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3 / steps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(nprobe):
            st = step(st)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_t = lambda e: (getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0))
    ka = prof.key_averages()
    device_ms = sum(dev_t(e) for e in ka if e.device_type == cuda) \
        / 1e3 / nprobe
    if cell == "engine":
        st = eng._ring.sim.state
        st = st.map(lambda x: x[..., None])
        batch = 1
    return dict(package=os.path.dirname(cityflow_tpu_torch.__file__),
                cell=cell, batch=batch, steps=steps, ms_per_step=wall_ms,
                device_ms_per_step=device_ms,
                device_busy=device_ms / wall_ms[0],
                overflow=int(st.overflow.max()),
                vehicles_env0=int(st.n_l[:, 0].sum() + st.n_k[:, 0].sum()),
                warm_s=warm_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--cell", default="main",
                    choices=("main", "mixed", "engine"))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_ring_cell: no CUDA device")
    res = run(root, args.cell, args.batch, args.steps, args.windows)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
