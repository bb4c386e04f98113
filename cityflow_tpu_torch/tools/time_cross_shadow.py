#!/usr/bin/env python3
"""G4 cross_pass and G15 shadow_insert on the card: every G4 and G15 call
of one step of the gen-1 paths, each held against its plain version and
then timed (kernel, plain version, kernel) beside its bound, after both
kernels' seeded edge cases (tools/kernel_cases.py).

    python -m cityflow_tpu_torch.tools.time_cross_shadow \
        [--paths gen1-lc,gen1-lc-batch,gen1,gen1-batch] [--reps 20] \
        [--out FILE]

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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="gen1-lc,gen1-lc-batch,gen1,"
                                       "gen1-batch")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
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
    recorded = {}
    if {"gen1-lc", "gen1-lc-batch"} & set(paths):
        recorded["gen1-lc"], recorded["gen1-lc-batch"] = lc_calls()
    for path in paths:
        calls = recorded.pop(path, None) or gen1_calls(path)
        fast = path.endswith("batch")
        rows = g4_rows(path, calls["cross_pass"], args.reps, fast)
        if "shadow_insert" in calls:
            rows += g15_rows(calls["shadow_insert"], args.reps, fast)
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
