#!/usr/bin/env python3
"""Where the batched ring step's device time goes, by operator.

Runs the 30x30 main path (p1 + p2, B envs; or another config, e.g. the
lane-change grid with --warmup 1960) on the card, warms up, times a few steps without the profiler (wall clock, synchronised), then records
as many under torch.profiler and prints the operators and kernels by self
device time, plus the device's busy share: kernel time per step over the
unprofiled wall time per step.

    python -m cityflow_tpu_torch.tools.profile_ring \
        [--config benchmarks/config_30x30.json] [--batch 128] [--steps 3] \
        [--out profile.txt]

--regions instead splits the step by the region marks of core/ring.py
(`_span`): CUDA events at each mark and around each kernel wrapper call,
so each region's device time divides into its kernels' and the plain
PyTorch between them. It prints one JSON line, {"regions": {name:
{"plain_ms", "kernel_ms"}}, "kernels": {name: ms}, "plain_ms",
"step_ms"}, ms a step. --templates FLOW gives flow i the i mod n-th
vehicle of FLOW (tests/fixtures/flow_2x2_mixed.json for the template
cells), staged under its own name.

The config's roadnet and flow are staged under the checkout's build/
(tools/scenario.py).
"""

import argparse
import contextlib
import gc
import json
import os
import time

import torch

# the kernel wrappers the ring step calls by name, per module
_WRAPPED = {
    "ring": ("gather_rows", "cross_caps", "car_follow", "ring_commit",
             "notify_winners", "ring_admit", "ring_exits",
             "ring_exits_pairs", "ring_exits_finish", "route_rows",
             "tpl_params", "lane_history", "front_leaders",
             "front_leaders_lc", "pack_forward", "pack_entrants",
             "pack_candidates", "pack_approach"),
    "ring_lc": ("lc_signal", "lc_receive", "lc_insert", "lc_partner",
                "gap_refresh")}


@contextlib.contextmanager
def _region_events():
    """core/ring.SPANS on, and each kernel wrapper bracketed by events in
    the same list ("K:<name>" before, "/K" after)."""
    from cityflow_tpu_torch.core import ring, ring_lc
    mods = {"ring": ring, "ring_lc": ring_lc}
    spans = []
    orig = {}

    def wrap(name, fn):
        def call(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            s.record()
            spans.append(("K:" + name, s))
            out = fn(*a, **k)
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            spans.append(("/K", e))
            return out
        return call

    for m, names in _WRAPPED.items():
        for n in names:
            if hasattr(mods[m], n):
                orig[(m, n)] = getattr(mods[m], n)
                setattr(mods[m], n, wrap(n, orig[(m, n)]))
    ring.SPANS = spans
    gc.collect()
    gc.disable()
    try:
        yield spans
    finally:
        gc.enable()
        ring.SPANS = None
        for (m, n), f in orig.items():
            setattr(mods[m], n, f)


def split_regions(spans):
    """{region: [plain ms, kernel ms]} and {kernel: ms} from one list of
    marks: the time between two consecutive events books to the kernel
    they bracket, else to the plain PyTorch of the open region."""
    regions, kern = {}, {}
    region, inside = None, None
    for (name, ev), (_, nxt) in zip(spans, spans[1:]):
        if name.startswith("K:"):
            inside = name[2:]
        elif name == "/K":
            inside = None
        else:
            region = name
        ms = ev.elapsed_time(nxt)
        r = regions.setdefault(region, [0.0, 0.0])
        if inside is not None:
            r[1] += ms
            kern[inside] = kern.get(inside, 0.0) + ms
        elif not name.endswith("_end"):
            r[0] += ms
    return regions, kern


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="benchmarks/config_30x30.json")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rows", type=int, default=40)
    ap.add_argument("--out", default=None)
    ap.add_argument("--lane-slots", type=int, default=40,
                    help="0 = build_sim's default")
    ap.add_argument("--templates", default=None)
    ap.add_argument("--regions", action="store_true")
    args = ap.parse_args(argv)

    from cityflow_tpu_torch import ring_sim
    from cityflow_tpu_torch.compiler.net import compile_scenario
    from cityflow_tpu_torch.core.ring import (
        batch_ring_state, ring_step_p1_batched, ring_step_p2_batched)
    from cityflow_tpu_torch.tools.scenario import mixed_templates, prepare

    if args.templates:
        name = os.path.splitext(os.path.basename(args.config))[0] + "_mixed"
        cfg_path = prepare(args.config, name=name,
                           templates=mixed_templates(args.templates))
    else:
        cfg_path = prepare(args.config)
    sim = ring_sim.build_sim(compile_scenario(cfg_path),
                             horizon=args.warmup + 2 * args.steps + 8,
                             sl=args.lane_slots or None)
    st = batch_ring_state(sim.state, 1)

    def step(s):
        s, m = ring_step_p1_batched(sim.tables, sim.cfg, s, sim.q)
        return ring_step_p2_batched(sim.tables, sim.cfg, s, m)

    # the warm-up runs one env and the batch starts from copies of it, as
    # in tools/bench.py
    for _ in range(max(args.warmup, 1) - 1):
        st = step(st)
    st = step(batch_ring_state(st.map(lambda x: x[..., 0]), args.batch))
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(args.steps):
        st = step(st)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / args.steps
    if args.regions:
        regions, kern = {}, {}
        with _region_events() as spans:
            for _ in range(args.steps):
                torch.cuda._sleep(100_000_000)
                st = step(st)
                torch.cuda.synchronize()
                r, k = split_regions(spans)
                spans.clear()
                for n, (p, q) in r.items():
                    acc = regions.setdefault(n, [0.0, 0.0])
                    acc[0] += p / args.steps
                    acc[1] += q / args.steps
                for n, v in k.items():
                    kern[n] = kern.get(n, 0.0) + v / args.steps
        line = dict(
            card=torch.cuda.get_device_name(0), config=args.config,
            templates=args.templates, batch=args.batch, steps=args.steps,
            wall_ms=wall_ms,
            regions={n: dict(plain_ms=p, kernel_ms=q)
                     for n, (p, q) in regions.items()},
            kernels=kern, plain_ms=sum(p for p, _ in regions.values()),
            step_ms=sum(p + q for p, q in regions.values()))
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        return line
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
