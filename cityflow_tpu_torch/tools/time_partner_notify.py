#!/usr/bin/env python3
"""L4 lc_partner and G3 notify_cross on the card, against another
checkout's (the parent commit's) kernels on the same recorded calls: A B B
A (the other checkout, this one, this one, the other), each reading the
mean of `reps` launches, after both versions' outputs are held equal.

    python -m cityflow_tpu_torch.tools.time_partner_notify --parent DIR \
        [--paths lc,lc1,gen1,gen1-batch,gen1-lc-batch] [--reps 20] \
        [--out FILE]

Run from the root of the repo (it imports chip_smoke.py's recording,
timing and bound helpers). DIR is a checkout of the other commit (for
example `git archive` of the parent unpacked into a git-ignored
directory): its csrc/lc_partner.cu and csrc/notify_cross.cu are built
into a library of their own under build/, and its kernels/lc_partner.py
and kernels/notify_cross.py are loaded under other module names with that
library, so its wrappers run as they stand there (other_kernels; the G3
rows need a checkout whose G3 takes the same arguments: one whose G3
reads G1's attribute packs is compared by time_cross_shadow --parent).

The paths are chip_smoke.py's. lc: one more step of the 30x30 lane-change
ring at B = 128 after 1960 warm-up steps; its three L4 calls are timed as
a step (this checkout: one match and two gathers; the other: its calls
on the same channels); lc1: the same at B = 1 (env 0 of that state: the
ring Engine's layout). gen1, gen1-batch, gen1-lc-batch: G3's call of one
more step of the exact Engine at one env, the fast step at B = 128 and
the lane-change step at B = 128 (tools/time_cross_shadow's recordings).
It prints the ptxas lines of this checkout's kernels, a line per path
and, last, one JSON object with every reading, each call's bound and the
card's name and power limit.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import types

import torch

from cityflow_tpu_torch.tools.time_follow_caps import HERE
from cityflow_tpu_torch.tools.time_receive_admit import bound, ptxas_lines

KERNELS = ("lc_partner_match", "lc_partner_gather", "notify_cross_kernel")
BATCH = 128
LC_WARMUP = 1960
LC_CFG = os.path.join("benchmarks", "config_30x30_lc.json")


# the pack columns of core.step in a checkout whose G3 reads G1's
# attribute packs; its notify_cross.py imports them from core.step
PACK_COLUMNS = ("A_DIS", "A_LEN", "A_SPEED", "A_MAXNEG", "A_YIELD", "A_UPA",
                "A_TURNSPD", "A_MAXSPD", "A_CYC", "A_PREV")


def other_kernels(root, names=("lc_partner", "notify_cross")):
    """The other checkout's wrapper modules of the kernels `names`, bound
    to a library built from their sources there."""
    from cityflow_tpu_torch.core import step as step_mod
    from cityflow_tpu_torch.kernels import _lib
    csrc = os.path.join(root, "cityflow_tpu_torch", "csrc")
    out = os.path.join(_lib.BUILD_DIR, "other")
    os.makedirs(out, exist_ok=True)
    nvcc = _lib._nvcc()
    objs, procs = [], []
    for f in (n + ".cu" for n in names):
        obj = os.path.join(out, f + ".o")
        procs.append(subprocess.Popen([nvcc, *_lib.ARCH_FLAGS, *_lib.CFLAGS,
                                       "-c", os.path.join(csrc, f), "-o",
                                       obj]))
        objs.append(obj)
    for p in procs:
        assert p.wait() == 0, "nvcc failed on the other checkout's sources"
    so = os.path.join(out, "_".join(names) + ".so")
    subprocess.run([nvcc, *_lib.ARCH_FLAGS, "-shared", *objs, "-o", so],
                   check=True)
    lib = ctypes.CDLL(so)
    for n in names:
        fn = getattr(lib, n)
        mode = [ctypes.c_int] if n in _lib.WITH_MODE else []
        fn.argtypes = [ctypes.c_void_p] + mode + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    shim = types.SimpleNamespace(
        lib=lambda: lib, **{k: getattr(_lib, k) for k in (
            "check_args", "check", "stream_ptr", "fp32", "FLOATS")})
    mods = {}
    lent = [k for k in PACK_COLUMNS if not hasattr(step_mod, k)]
    for k in lent:
        setattr(step_mod, k, PACK_COLUMNS.index(k))
    try:
        for n in names:
            spec = importlib.util.spec_from_file_location(
                f"other_{n}", os.path.join(root, "cityflow_tpu_torch",
                                           "kernels", n + ".py"))
            m = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(m)
            m._lib = shim
            mods[n] = m
    finally:
        for k in lent:
            delattr(step_mod, k)
    return mods


def abba(other, this, reps):
    """(the other's two readings, this one's two), A B B A."""
    import chip_smoke as cs
    a1 = cs.time_cuda(other, reps)
    b1 = cs.time_cuda(this, reps)
    b2 = cs.time_cuda(this, reps)
    a2 = cs.time_cuda(other, reps)
    return [a1, a2], [b1, b2]


def lc_states():
    """The [lc] state after the warm-up, batched at BATCH, and env 0 of it
    at B = 1: (sim, {"lc": state, "lc1": state})."""
    import chip_smoke as cs
    from cityflow_tpu_torch.compiler.net import compile_scenario
    from cityflow_tpu_torch.tools import bench
    from cityflow_tpu_torch.tools.scenario import prepare
    cfg = prepare(os.path.join(HERE, LC_CFG))
    args = bench.parser().parse_args(
        ["--config", cfg, "--batch", str(BATCH), "--warmup", str(LC_WARMUP),
         "--window", "0", "--steps", "1", "--lane-slots", "40"])
    r = bench.run_ring(args, compile_scenario(cfg), BATCH)
    st = r["state"]
    one = st.map(lambda x: x[..., :1].contiguous())
    return r["sim"], {"lc": cs.fresh(st), "lc1": one}


def l4_rows(path, sim, state, other, reps):
    """One lane-change step's L4 calls, held equal to the other
    checkout's, then timed as a step A B B A."""
    import chip_smoke as cs
    from cityflow_tpu_torch.kernels import lc_partner as l4
    calls = cs.record_lc_calls(sim, state)
    cs.check_partner_calls(path, calls)
    (a, _), = calls["lc_partner"]
    uid, sh, l_dir, n_l, chg, chans, tabs = a
    gathers = [g for g, _ in calls["lc_partner_gather"]]
    sets = [chans] + [g[1] for g in gathers]
    mine = l4.lc_partner(*a)
    for i, ch in enumerate(sets):
        theirs = other.lc_partner(uid, sh, l_dir, n_l, chg, ch, tabs)
        vals = mine[0] if i == 0 else l4.lc_partner_gather(mine[2], ch, tabs)
        _, bad = cs._bitwise("lc_partner", (vals, mine[1]), theirs)
        assert bad == 0, f"[{path}] L4 call {i}: {bad} values differ"

    def theirs_step():
        for ch in sets:
            other.lc_partner(uid, sh, l_dir, n_l, chg, ch, tabs)

    def mine_step():
        l4.lc_partner(*a)
        for g in gathers:
            l4.lc_partner_gather(*g)
    other_ms, ms = abba(theirs_step, mine_step, reps)
    nbytes = cs.lc_work("lc_partner", a, {})[0] + sum(
        cs.lc_work("lc_partner_gather", g, {})[0] for g in gathers)
    rows = [dict(call="lc_partner a step (1 match + 2 gathers)",
                 B=uid.shape[-1], other_ms=other_ms, ms=ms,
                 bound_ms=bound(nbytes, 0))]
    # each call of this checkout's alone
    for n, (x, fn) in [("lc_partner", (a, l4.lc_partner))] + [
            ("lc_partner_gather", (g, l4.lc_partner_gather))
            for g in gathers]:
        rows.append(dict(call=n, B=uid.shape[-1],
                         ms=cs.time_cuda(lambda: fn(*x), reps),
                         bound_ms=bound(cs.lc_work(n, x, {})[0], 0)))
    return rows


def g3_rows(path, calls, other, reps):
    """Every G3 call: held equal to the other checkout's, then A B B A."""
    import chip_smoke as cs
    from cityflow_tpu_torch.kernels import notify_cross as g3
    fast = path != "gen1"
    flops = cs.H100_F32_FLOPS if fast else cs.H100_F64_FLOPS
    rows = []
    for a, _ in calls:
        mine = g3.notify_cross(*a)
        _, bad = cs._bitwise("notify_cross", mine, other.notify_cross(*a))
        assert bad == 0, f"[{path}] G3: {bad} values differ"
        _, bad = cs._bitwise("notify_cross", mine, g3.notify_cross_plain(*a))
        assert bad == 0, f"[{path}] G3: {bad} values differ from the plain"
        other_ms, ms = abba(lambda: other.notify_cross(*a),
                            lambda: g3.notify_cross(*a), reps)
        rows.append(dict(call="notify_cross", B=a[2].shape[0],
                         other_ms=other_ms, ms=ms,
                         bound_ms=bound(*cs.notify_work(a, mine), flops)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout of the commit to compare with")
    ap.add_argument("--paths", default="lc,lc1,gen1,gen1-batch,"
                                       "gen1-lc-batch")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        sys.exit("time_partner_notify: no CUDA device")
    import chip_smoke as cs
    from cityflow_tpu_torch.tools import time_cross_shadow as tcs
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    res = dict(card=smi, calls=[], ptxas=ptxas_lines(KERNELS))
    for line in res["ptxas"]:
        print(f"[ptxas] {line}", flush=True)
    other = other_kernels(os.path.abspath(args.parent))
    paths = [p for p in args.paths.split(",") if p]
    if {"lc", "lc1"} & set(paths):
        sim, states = lc_states()
        for path in ("lc", "lc1"):
            if path in paths:
                for row in l4_rows(path, sim, states[path],
                                   other["lc_partner"], args.reps):
                    row["path"] = path
                    res["calls"].append(row)
                    print(f"[{path}] {row}", flush=True)
        del sim, states
        torch.cuda.empty_cache()
    for path in paths:
        if path in ("lc", "lc1"):
            continue
        if path == "gen1-lc-batch":
            calls = tcs.lc_calls(("notify_cross",))[1]
        else:
            calls = tcs.gen1_calls(path, ("notify_cross",))
        for row in g3_rows(path, calls["notify_cross"],
                           other["notify_cross"], args.reps):
            row["path"] = path
            res["calls"].append(row)
            print(f"[{path}] {row}", flush=True)
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
