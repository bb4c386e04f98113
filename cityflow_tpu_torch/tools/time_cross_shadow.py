#!/usr/bin/env python3
"""G4 cross_pass and G15 shadow_insert on the card: every G4 and G15 call
of one step of the gen-1 paths, each held against its plain version and
then timed (kernel, plain version, kernel) beside its bound, after both
kernels' seeded edge cases (tools/kernel_cases.py).

    python -m cityflow_tpu_torch.tools.time_cross_shadow \
        [--paths gen1-lc,gen1-lc-batch,gen1,gen1-batch] [--reps 20] \
        [--out FILE] [--parent DIR] [--split]

With --parent DIR (a checkout of another commit, for example the parent
unpacked by `git archive` into a git-ignored directory), G1, G3 and G7's
yield mode of the same step are also held against that checkout's
kernels and timed A B B A beside them (parent_rows): G1 on every call,
the other's G1 with the attribute packs and G3 on them where that
checkout reads G1's lanelink tables. With --split, each G1 call's device
time by launch (memset, count, scan, place, rank) from the profiler.

Run from the root of the repo (it imports chip_smoke.py's timing, compare
and bound helpers). The paths are chip_smoke.py's: gen1 the exact Engine
on 30x30 at one env (step 301); gen1-batch the fast Engine's step-300
state in a batch of 128 (one batched step); gen1-lc the exact Engine on
30x30_lc under DURATION at one env (step 1961); gen1-lc-batch that
Engine's step-1960 state cast to float32 in a batch of 128 (one batched
step). G15 writes its state in place, so it is recorded on a copy and
each of its calls (a check or a timed call) runs on a fresh copy,
untimed. It prints the ptxas lines of both kernels' functions, G4's
funnel on each path, a line per call and, last, one JSON object with
every reading, each call's bound (G4's as the lazy decision reads this
data, G15's in place) and the card's name and power limit.
"""

import argparse
import json
import os
import sys

import torch

from cityflow_tpu_torch.tools.time_follow_caps import HERE
from cityflow_tpu_torch.tools.time_receive_admit import bound, ptxas_lines

KERNELS = ("cross_pass_kernel", "shadow_scan", "shadow_write")
BATCH = 128
GEN1_WARMUP = 300
GEN1_LC_WARMUP = 1960
GEN1_CFG = os.path.join("benchmarks", "config_30x30.json")
GEN1_LC_CFG = os.path.join("benchmarks", "config_30x30_lc.json")


def g4_rows(path, calls, reps, fast):
    """Every G4 call: bit for bit against the plain version, then timed
    (kernel, plain, kernel)."""
    import chip_smoke as cs
    from cityflow_tpu_torch.kernels import cross_pass as g4
    cs.log_cross_funnel(path, calls)
    flops = cs.H100_F32_FLOPS if fast else cs.H100_F64_FLOPS
    rows = []
    for a, _ in calls:
        _, bad = cs._bitwise("cross_pass", g4.cross_pass(*a),
                             cs.cross_plain_by_envs(*a))
        assert bad == 0, f"cross_pass: {bad} values not bitwise"
        ms = [cs.time_cuda(lambda: g4.cross_pass(*a), reps)]
        plain_ms = cs.time_cuda(lambda: cs.cross_plain_by_envs(*a), reps)
        ms.append(cs.time_cuda(lambda: g4.cross_pass(*a), reps))
        fun = cs.cross_funnel(a)
        rows.append(dict(
            call="cross_pass", B=a[0].shape[0], V=a[0].shape[1],
            KC=a[9]["lnk_cross_d"].shape[1], ms=ms, plain_ms=plain_ms,
            bound_ms=bound(fun["bytes"], fun["ops"], flops), funnel=fun))
    return rows


def g15_rows(calls, reps, fast):
    """Every G15 call (recorded on a copy): kernel and plain version each
    on a fresh copy, bit for bit, then timed (kernel, plain, kernel)."""
    import chip_smoke as cs
    from cityflow_tpu_torch.kernels import shadow_insert as g15
    flops = cs.H100_F32_FLOPS if fast else cs.H100_F64_FLOPS
    rows = []
    for a, _ in calls:
        _, bad = cs._bitwise("shadow_insert",
                             g15.shadow_insert(*cs.shadow_copy(a)),
                             g15.shadow_insert_plain(*cs.shadow_copy(a)))
        assert bad == 0, f"shadow_insert: {bad} values not bitwise"
        setup = lambda: cs.shadow_copy(a)
        t = lambda f: cs.time_cuda_fresh(setup, lambda x: f(*x), reps)
        ms = [t(g15.shadow_insert)]
        plain_ms = t(g15.shadow_insert_plain)
        ms.append(t(g15.shadow_insert))
        st, _, do_change, _, MS = a
        pairs = int(torch.minimum(do_change.sum(-1).clamp(max=MS),
                                  (~st.active).sum(-1).clamp(max=MS)).sum())
        rows.append(dict(
            call="shadow_insert", B=do_change.shape[0],
            V=do_change.shape[1], MS=MS, pairs=pairs, ms=ms,
            plain_ms=plain_ms, bound_ms=bound(*cs.shadow_work(a), flops)))
    return rows


def case_rows(reps):
    """Both kernels on each seeded case (G15 on fresh copies), bit for bit
    against the plain versions; then timed."""
    import chip_smoke as cs
    from cityflow_tpu_torch.kernels import cross_pass as g4
    from cityflow_tpu_torch.kernels import shadow_insert as g15
    from cityflow_tpu_torch.tools import kernel_cases as kc
    rows = []
    for name, case in kc.cross_cases():
        a = kc.cross_args(case, "cuda")
        _, bad = cs._bitwise(name, g4.cross_pass(*a),
                             g4.cross_pass_plain(*a))
        assert bad == 0, f"cross_pass[{name}]: {bad} values not bitwise"
        rows.append(dict(call=f"cross_pass[{name}]", ms=cs.time_cuda(
            lambda: g4.cross_pass(*a), reps)))
    for name, case in kc.shadow_cases():
        setup = lambda: kc.shadow_args(case, "cuda")
        _, bad = cs._bitwise(name, g15.shadow_insert(*setup()),
                             g15.shadow_insert_plain(*setup()))
        assert bad == 0, f"shadow_insert[{name}]: {bad} values not bitwise"
        rows.append(dict(call=f"shadow_insert[{name}]",
                         ms=cs.time_cuda_fresh(
                             setup, lambda x: g15.shadow_insert(*x), reps)))
    return rows


def gen1_calls(path, names=("cross_pass",)):
    """{kernel: recorded calls} of one step of gen1 / gen1-batch, of the
    kernels `names`."""
    from cityflow_tpu_torch.core.state import pad_state
    from cityflow_tpu_torch.engine import Engine
    from cityflow_tpu_torch.parallel.batch import (
        init_batch_state, make_batched_step)
    from cityflow_tpu_torch.tools.scenario import prepare
    fast = path == "gen1-batch"
    kw = dict(exact=False, backend="gen1") if fast else {}
    eng = Engine(prepare(os.path.join(HERE, GEN1_CFG)),
                 spawn_horizon=GEN1_WARMUP + 16, **kw)
    for _ in range(GEN1_WARMUP):
        eng.next_step()
    import chip_smoke as cs
    if not fast:
        return cs.record_gen1_calls(eng.next_step, names)
    cfg, net, spawn = eng.cfg, eng._net_dev, eng._spawn_dev
    stb = init_batch_state(cfg, pad_state(eng.state, cfg.max_vehicles),
                           BATCH)
    del eng
    step_b = make_batched_step(net, cfg, with_obs=False)
    # the batched step writes its state (donated): it steps a copy
    return cs.record_gen1_calls(lambda: step_b(cs.fresh(stb), spawn), names)


def lc_calls(names=("cross_pass", "shadow_insert")):
    """({kernel: calls} of gen1-lc's step 1961, of gen1-lc-batch's), of
    the kernels `names`."""
    import dataclasses
    from cityflow_tpu_torch.carry import (
        net_tensors, sim_state_from_numpy, sim_state_to_numpy)
    from cityflow_tpu_torch.core.state import pad_state
    from cityflow_tpu_torch.engine import Engine
    from cityflow_tpu_torch.parallel.batch import (
        init_batch_state, make_batched_step)
    from cityflow_tpu_torch.tools.scenario import prepare
    cfg_path = prepare(os.path.join(HERE, GEN1_LC_CFG),
                       name="config_30x30_lc_duration",
                       routerType="DURATION")
    eng = Engine(cfg_path, spawn_horizon=GEN1_LC_WARMUP + 16)
    for _ in range(GEN1_LC_WARMUP):
        eng.next_step()
    warm = eng.state
    import chip_smoke as cs
    one = cs.record_gen1_calls(eng.next_step, names)
    cfg = dataclasses.replace(eng.cfg, exact=False)
    net = net_tensors(eng.net, torch.float32, eng.device)
    spawn = eng._spawn_dev
    st = sim_state_from_numpy(sim_state_to_numpy(
        pad_state(warm, cfg.max_vehicles)), eng.device, torch.float32)
    del eng, warm
    stb = init_batch_state(cfg, st, BATCH)
    del st
    step_b = make_batched_step(net, cfg, with_obs=False)
    # the batched step writes its state (donated): it steps a copy
    return one, cs.record_gen1_calls(lambda: step_b(cs.fresh(stb), spawn),
                                     names)


PARENT_KERNELS = ("arrange", "notify_cross", "lc_plan")


def attr_packs(leaves):
    """The attribute packs a checkout whose G3 reads G1's dense lanelink
    tables builds twice a lane-change step (once a step without): fattrs
    (B, V, 10) (dis, length, speed, maxNegAcc, yieldDistance,
    usualPosAcc, turnSpeed, maxSpeed, cyc, prev_drv) and iattrs (B, V, 2)
    (enter_ll_time, priority)."""
    p, f = leaves["params"], leaves["dis"].dtype
    fattrs = torch.stack([
        leaves["dis"], p[..., 1], leaves["speed"], p[..., 4], p[..., 10],
        p[..., 5], p[..., 11], p[..., 8], leaves["cyc"].to(f),
        leaves["prev_drv"].to(f)], dim=-1)
    return fattrs, torch.stack([leaves["enter_ll_time"],
                                leaves["priority"]], dim=-1)


def parent_rows(path, calls, other, reps, fast):
    """G1, G3 and G7's yield mode of one step against another checkout's
    (other_kernels), A B B A, each pair held equal first. G1: every call,
    the other's on the same inputs; then the call whose arrangement G3
    reads, the other's with the attribute packs (it builds its lanelink
    tables there), and the packs' own build; G3 on that arrangement and
    the packs; G7 yield on the same inputs."""
    import chip_smoke as cs
    from cityflow_tpu_torch.kernels import arrange as g1
    from cityflow_tpu_torch.kernels import lc_plan as g7
    from cityflow_tpu_torch.kernels import notify_cross as g3
    from cityflow_tpu_torch.tools.time_partner_notify import abba
    flops = cs.H100_F32_FLOPS if fast else cs.H100_F64_FLOPS
    o1, o3, o7 = (other[n] for n in PARENT_KERNELS)
    keys = ("leader", "first_of", "last_of", "sorted_idx", "overflow_link")
    rows = []
    for i, (a, _) in enumerate(calls["arrange"]):
        mine, theirs = g1.arrange(*a), o1.arrange(*a)
        for k in keys:
            assert cs.bitwise_equal(mine[k], theirs[k]), f"arrange {i}: {k}"
        other_ms, ms = abba(lambda: o1.arrange(*a), lambda: g1.arrange(*a),
                            reps)
        rows.append(dict(call=f"arrange[{i}]", other_ms=other_ms, ms=ms,
                         bound_ms=bound(*cs.gen1_work("arrange", a, {},
                                                      mine), flops)))
    for a, _ in calls["notify_cross"]:
        net, arr, veh_next, ll_avail, leaves, L, K = a
        fa, ia = attr_packs(leaves)
        (fed, _), = [(c, k) for c, k in calls["arrange"] if torch.equal(
            g1.arrange(*c)["sorted_idx"], arr["sorted_idx"])][:1]
        tables = o1.arrange(*fed, fa, ia)
        mine, theirs = g3.notify_cross(*a), o3.notify_cross(
            net, tables, veh_next, ll_avail, fa, ia, L)
        _, bad = cs._bitwise("notify_cross", mine, theirs)
        assert bad == 0, f"[{path}] G3: {bad} values differ from the other"
        other_ms, ms = abba(lambda: o1.arrange(*fed, fa, ia),
                            lambda: g1.arrange(*fed), reps)
        rows.append(dict(call="arrange, the call G3 reads (other: with the "
                              "packs and tables)", other_ms=other_ms, ms=ms))
        rows.append(dict(call="attr_packs (other only)", other_ms=[
            cs.time_cuda(lambda: attr_packs(leaves), reps)]))
        other_ms, ms = abba(lambda: o3.notify_cross(
            net, tables, veh_next, ll_avail, fa, ia, L),
            lambda: g3.notify_cross(*a), reps)
        rows.append(dict(call="notify_cross", other_ms=other_ms, ms=ms,
                         bound_ms=bound(*cs.notify_work(a, mine), flops)))
        del tables, fa, ia
    for a, k in calls.get("lc_plan", ()):
        if a[0] != "yield":
            continue
        mine, theirs = g7.lc_plan(*a, **k), o7.lc_plan(*a, **k)
        assert cs.bitwise_equal(mine, theirs), f"[{path}] G7 yield differs"
        other_ms, ms = abba(lambda: o7.lc_plan(*a, **k),
                            lambda: g7.lc_plan(*a, **k), reps)
        st = a[1]
        rows.append(dict(call="lc_plan@yield", other_ms=other_ms, ms=ms,
                         receivers=int((st.lc_recv >= 0).sum()),
                         bound_ms=bound(*cs.yield_work(
                             st, st.dis.element_size()), flops)))
    return rows


def g1_split_rows(calls, reps):
    """Each G1 call's device time by launch (the memset and its four
    kernels), from the torch profiler over `reps` calls."""
    from cityflow_tpu_torch.kernels import arrange as g1
    rows = []
    for i, (a, _) in enumerate(calls):
        g1.arrange(*a)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                g1.arrange(*a)
            torch.cuda.synchronize()
        split = {e.key.split("(")[0].replace("void ", ""):
                 round(e.self_device_time_total / 1e3 / reps, 4)
                 for e in prof.key_averages()
                 if e.self_device_time_total > 0}
        rows.append(dict(call=f"arrange[{i}] split", split=split,
                         running=int(a[0].sum())))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="gen1-lc,gen1-lc-batch,gen1,"
                                       "gen1-batch")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--split", action="store_true",
                    help="G1's device time by launch on each path call")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the commit to compare G1, G3 and "
                         "G7's yield mode with (parent_rows)")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        sys.exit("time_cross_shadow: no CUDA device")
    import chip_smoke as cs
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    res = dict(card=smi, calls=[], ptxas=ptxas_lines(KERNELS))
    for line in res["ptxas"]:
        print(f"[ptxas] {line}", flush=True)
    for row in case_rows(args.reps):
        row["path"] = "cases"
        res["calls"].append(row)
        print(f"[cases] {row['call']} ms={row['ms']:.4f}", flush=True)
    paths = [p for p in args.paths.split(",") if p]
    other = None
    names = ("cross_pass", "shadow_insert") + (
        ("arrange",) if args.split else ())
    if args.parent:
        from cityflow_tpu_torch.tools.time_partner_notify import other_kernels
        other = other_kernels(os.path.abspath(args.parent), PARENT_KERNELS)
        names += tuple(n for n in PARENT_KERNELS if n not in names)
    recorded = {}
    if {"gen1-lc", "gen1-lc-batch"} & set(paths):
        recorded["gen1-lc"], recorded["gen1-lc-batch"] = lc_calls(names)
    for path in paths:
        calls = recorded.pop(path, None) or gen1_calls(
            path, tuple(n for n in names if n != "shadow_insert"))
        fast = path.endswith("batch")
        rows = g4_rows(path, calls["cross_pass"], args.reps, fast)
        if calls.get("shadow_insert"):
            rows += g15_rows(calls["shadow_insert"], args.reps, fast)
        if other is not None:
            rows += parent_rows(path, calls, other, args.reps, fast)
        if args.split:
            rows += g1_split_rows(calls["arrange"], args.reps)
        for row in rows:
            row["path"] = path
            res["calls"].append(row)
            print(f"[{path}] " + " ".join(
                f"{k}={v}" for k, v in row.items() if k != "path"),
                flush=True)
        del calls
        torch.cuda.empty_cache()
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
