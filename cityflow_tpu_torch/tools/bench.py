#!/usr/bin/env python3
"""Benchmark: aggregate env-steps/s of the batched PyTorch ring simulator.

The metric of record: the 30x30 grid, gen-2 ring layout, float32, B envs
in the trailing-batch layout, on one CUDA device. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Baseline: the reference C++ engine, 1 thread, scaled by 8 for an 8-thread
proxy (optimistic for the reference: it scales sub-linearly):
4x4 = 182 steps/s, 16x16 ~ 100, 30x30 = 67.

Every timed region ends in torch.cuda.synchronize(). The config's roadnet
and flow are staged under the checkout's build/ (tools/scenario.py).

    python -m cityflow_tpu_torch.tools.bench --config benchmarks/config_30x30.json
    python -m cityflow_tpu_torch.tools.bench \
        --config benchmarks/config_30x30_lc.json --warmup 1960
"""

import argparse
import json
import sys
import time

import torch

REF_1T = {"4x4": 182.0, "16x16": 100.0, "30x30": 67.0, "example": 670.0}

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_ring(args, net, batch, device=None, on_step=None, on_warmup=None):
    """Build the sim, warm up, time the batched p1 + p2 steps. Returns a
    dict of the measurement and the final batched state. The warm-up runs
    one env and the batch starts from copies of it: every env runs the
    same scenario from the same seed, so that is the state a batched
    warm-up reaches, at a fraction of the cost (the lane-change grid's
    first changes come at step 1779). Its last step is batched and timed
    as first_step_s. `on_step(state)`, when given, runs after each timed
    step (a check that the caller wants inside the window);
    `on_warmup(state)` after each single-env warm-up step."""
    from cityflow_tpu_torch import ring_sim
    from cityflow_tpu_torch.core.ring import (
        batch_ring_state, ring_step_p1_batched, ring_step_p2_batched)

    t0 = time.time()
    budget = args.window if args.window else args.steps
    sim = ring_sim.build_sim(net, horizon=args.warmup + budget + 8,
                             sl=args.lane_slots or None, device=device)
    dev = sim.device
    build_s = time.time() - t0
    B = batch

    def step_b(s):
        s, m = ring_step_p1_batched(sim.tables, sim.cfg, s, sim.q)
        return ring_step_p2_batched(sim.tables, sim.cfg, s, m)

    print(f"[stage] build_s={build_s:.1f}", file=sys.stderr, flush=True)
    one = batch_ring_state(sim.state, 1)
    steps_run = max(args.warmup, 1)
    for _ in range(steps_run - 1):
        one = step_b(one)
        if on_warmup is not None:
            on_warmup(one)
    bstate = batch_ring_state(one.map(lambda x: x[..., 0]), B)
    del one
    _sync(dev)
    t0 = time.time()
    bstate = step_b(bstate)
    _sync(dev)
    first_s = time.time() - t0
    if args.window:
        # the timed region loops the scenario's first W post-warmup steps,
        # restarting from the warm snapshot (the copy is timed in), until
        # --min-seconds of wall clock: a long measurement at the
        # benchmark's real density
        W = int(args.window)
        snap = bstate
        bstate = None
        steps = 0
        t0 = time.time()
        while True:
            s = snap.map(torch.clone)
            for _ in range(W):
                s = step_b(s)
                if on_step is not None:
                    on_step(s)
            _sync(dev)
            steps += W
            if time.time() - t0 >= args.min_seconds or steps >= args.steps:
                break
        dt = time.time() - t0
    else:
        steps = int(args.steps)
        t0 = time.time()
        s = bstate
        bstate = None
        for _ in range(steps):
            s = step_b(s)
            if on_step is not None:
                on_step(s)
        _sync(dev)
        dt = time.time() - t0
        steps_run += steps
    ov = int(s.overflow.max())
    veh = int(s.n_l[:, 0].sum() + s.n_k[:, 0].sum())
    return dict(seconds=dt, overflow=ov, vehicles=veh, build_s=build_s,
                first_step_s=first_s, steps=steps, steps_run=steps_run,
                state=s, sim=sim)


def run_ring_ladder(args, net, batch=None, device=None, on_step=None,
                    on_warmup=None):
    """run_ring at `batch` (default args.batch), halving the batch on
    CUDA out-of-memory until it fits (floor 1). Returns (result, batch)."""
    import gc
    batch = args.batch if batch is None else batch
    while True:
        try:
            return run_ring(args, net, batch, device, on_step,
                            on_warmup), batch
        except torch.cuda.OutOfMemoryError as e:
            print(f"ring OOM at batch={batch}: {str(e)[:200]}",
                  file=sys.stderr, flush=True)
            if batch <= 1:
                raise
            gc.collect()
            torch.cuda.empty_cache()
            batch //= 2
            print(f"retrying batch={batch}", file=sys.stderr, flush=True)


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="benchmarks/config_30x30.json")
    ap.add_argument("--layout", choices=["ring", "gen1", "auto"],
                    default="auto",
                    help="gen-2 ring (the port's path); gen1 is not ported")
    ap.add_argument("--batch", type=int, default=128,
                    help="env batch (trailing axis of every state leaf)")
    ap.add_argument("--steps", type=int, default=6144,
                    help="step budget of the timed region (and the spawn "
                         "horizon); with --window 0 exactly this many "
                         "consecutive steps")
    ap.add_argument("--window", type=int, default=300,
                    help="the timed region loops the scenario's first "
                         "WINDOW post-warmup steps until --min-seconds, "
                         "matching the reference's 300-step measurement; "
                         "0 = run --steps consecutive steps")
    ap.add_argument("--min-seconds", type=float, default=2.0,
                    help="minimum timed wall clock with --window")
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--lane-slots", type=int, default=40,
                    help="ring lane capacity; 40 = jam capacity, 0 = the "
                         "longest lane's capacity for the template that "
                         "packs densest (build_sim's default)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--ref-steps-per-s", type=float, default=None)
    ap.add_argument("--sweep", default=None,
                    help="comma list of batch sizes: run each through the "
                         "OOM ladder, write the table to --sweep-out, print "
                         "the line of the best batch")
    ap.add_argument("--sweep-out", default="SCALING_BATCH.json")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    from cityflow_tpu_torch.compiler.net import compile_scenario
    from cityflow_tpu_torch.device import resolve_device
    from cityflow_tpu_torch.tools.scenario import prepare

    dev = resolve_device(args.device)
    net = compile_scenario(prepare(args.config))
    scen = next((k for k in REF_1T if k in args.config), "other")
    ref = args.ref_steps_per_s or REF_1T.get(scen, 67.0)
    baseline = ref * 8  # 8-thread reference proxy
    if args.layout == "gen1":
        raise NotImplementedError("the batched gen-1 slot-pool step is not "
                                  "ported yet (ROADMAP.md queue 1, the "
                                  "gen-1 batched env)")
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"

    def run_once(batch):
        r, batch_used = run_ring_ladder(args, net, batch, dev)
        rate = batch_used * r["steps"] / r["seconds"]
        return {
            "metric": f"env_steps_per_sec_{scen}",
            "value": round(rate, 1),
            "unit": "env-steps/s",
            "vs_baseline": round(rate / baseline, 2),
            "layout": "ring",
            "lane_change": bool(net.host.config.get("laneChange", False)),
            "warmup": args.warmup,
            "batch": batch_used, "steps": r["steps"],
            "ms_per_batched_step": round(r["seconds"] * 1000 / r["steps"],
                                         2),
            "compile_s": round(r["first_step_s"], 1),
            "device": device,
            "overflow_flags": r["overflow"],
            "vehicles_per_env": r["vehicles"],
            "seconds": round(r["seconds"], 3),
            "window": args.window,
        }

    if not args.sweep:
        print(json.dumps(run_once(args.batch)))
        return
    rows = []
    for b in [int(x) for x in args.sweep.split(",")]:
        if rows and b <= rows[-1]["batch"]:
            continue            # the ladder already walked down past b
        r = run_once(b)
        r["batch_requested"] = b
        rows.append(r)
        print(json.dumps(r), file=sys.stderr, flush=True)
    best = max(rows, key=lambda r: r["value"])
    with open(args.sweep_out, "w") as f:
        json.dump({"kind": "batch_scaling_sweep", "config": args.config,
                   "device": device, "rows": rows,
                   "best_batch": best["batch"]}, f, indent=1)
    print(json.dumps(best))


if __name__ == "__main__":
    main()
