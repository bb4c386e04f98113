#!/usr/bin/env python3
"""R2 ring_exits (its exits stage) and O2 phase_pressure on the card,
against another checkout's (the parent commit's) kernels on the same
recorded calls: every output held equal, then A B B A (the other
checkout, this one, this one, the other), each reading the mean of `reps`
calls; and where each R2 version's time goes.

    python -m cityflow_tpu_torch.tools.time_exits_pressure --parent DIR \
        [--paths main,mixed,rl] [--reps 20] [--out FILE]

Run from the root of the repo (it imports chip_smoke.py's recording,
timing and bound helpers). DIR is a checkout of the other commit (for
example `git archive` of the parent unpacked into a git-ignored
directory): its csrc/ring_exits.cu and csrc/phase_pressure.cu are built
into a library of their own under build/, and its kernels/ring_exits.py
and kernels/phase_pressure.py are loaded under other module names with
that library, so its wrappers run as they stand there.

main, mixed, lc: one more step of chip_smoke.py's [main] / [mixed] / [lc]
ring path at B = 128 after its warm-up; engine: one more step of
chip_smoke.py's [ring-engine] (Engine(exact=False) on config_30x30.json,
the ring at one env) after its 300 warm-up steps. R2's exits call of
that step, each version on a fresh copy of the new distances (this
checkout clamps them in place). The split: each version on the same call
with its lanes alone (the argument block's LKp and lights set to 0), its
links alone (LNp and lights 0), its lights alone (LNp and LKp 0) and none
of them (the launches and the per-env sums of nothing). rl: O2 in both
modes on chip_smoke's [rl] state (RingVecEnv at B = 128 after its warm-up
under MaxPressure).

It runs O2's and R2's seeded cases first (tools/kernel_cases.py), prints
the ptxas lines of this checkout's kernels, a line per reading and, last,
one JSON object with every reading, each call's bound and the card's
name and power limit.
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

KERNELS = ("ring_exits_kernel", "exits_env_sums", "ring_env_sums",
           "phase_pressure_kernel")
BATCH = 128
# the argument-block fields zeroed for each part of R2's split
SPLIT = {"lanes": ("LKp", "lights"), "links": ("LNp", "lights"),
         "lights": ("LNp", "LKp"), "none": ("LNp", "LKp", "lights")}


class _Zeroing:
    """A kernel library whose ring_exits zeroes the named fields of its
    argument block before the launch (`zero`, empty: the call as given)."""

    def __init__(self, lib):
        self.lib, self.zero = lib, ()

    def ring_exits(self, aref, mode, stream):
        for f in self.zero:
            setattr(aref._obj, f, 0)
        return self.lib.ring_exits(aref, mode, stream)

    def __getattr__(self, name):
        return getattr(self.lib, name)


def _shim(lib):
    from cityflow_tpu_torch.kernels import _lib
    z = _Zeroing(lib)
    return z, types.SimpleNamespace(
        lib=lambda: z, **{k: getattr(_lib, k) for k in (
            "check_args", "check", "stream_ptr", "fp32", "FLOATS")})


def other_kernels(root):
    """The R2 and O2 wrapper modules of the checkout at `root`, bound to
    a library built from its two sources, that library's zeroing shim and
    ptxas' lines for it."""
    from cityflow_tpu_torch.kernels import _lib
    csrc = os.path.join(root, "cityflow_tpu_torch", "csrc")
    out = os.path.join(_lib.BUILD_DIR, "other")
    os.makedirs(out, exist_ok=True)
    nvcc = _lib._nvcc()
    objs, procs = [], []
    for f in ("ring_exits.cu", "phase_pressure.cu"):
        obj = os.path.join(out, f + ".o")
        procs.append(subprocess.Popen(
            [nvcc, *_lib.ARCH_FLAGS, *_lib.CFLAGS, "-Xptxas", "-v",
             "-c", os.path.join(csrc, f), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        objs.append(obj)
    ptxas = []
    for p in procs:
        log = p.communicate()[0].decode(errors="replace")
        assert p.returncode == 0, f"nvcc failed:\n{log}"
        ptxas += [x.strip() for x in log.splitlines()
                  if "registers" in x or "spill" in x]
    so = os.path.join(out, "r2_o2.so")
    subprocess.run([nvcc, *_lib.ARCH_FLAGS, "-shared", *objs, "-o", so],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.phase_pressure.argtypes = [vp, vp]
    lib.phase_pressure.restype = ctypes.c_int
    lib.ring_exits.argtypes = [vp, ctypes.c_int, vp]
    lib.ring_exits.restype = ctypes.c_int
    if hasattr(lib, "ring_exits_groups"):
        lib.ring_exits_groups.argtypes = [ll, ll, ll, vp, vp]
        lib.ring_exits_groups.restype = ctypes.c_int
    zero, shim = _shim(lib)
    mods = {}
    for n in ("ring_exits", "phase_pressure"):
        spec = importlib.util.spec_from_file_location(
            f"other_{n}", os.path.join(root, "cityflow_tpu_torch", "kernels",
                                       n + ".py"))
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        m._lib = shim
        mods[n] = m
    return mods, zero, ptxas


def abba(other, this, reps, setup=None):
    """(the other's two readings, this one's two), A B B A; with `setup`
    each call on a fresh setup() (untimed)."""
    import chip_smoke as cs
    t = (lambda f: cs.time_cuda(f, reps)) if setup is None else \
        (lambda f: cs.time_cuda_fresh(setup, f, reps))
    a1, b1, b2, a2 = t(other), t(this), t(this), t(other)
    return [a1, a2], [b1, b2]


def ring_state(path):
    """(sim, state) of chip_smoke's [main], [mixed] or [lc] path after its
    warm-up, batched at BATCH; for engine, the ring Engine's at one env
    (batched at 1, as its step runs it)."""
    import chip_smoke as cs
    from cityflow_tpu_torch.compiler.net import compile_scenario
    from cityflow_tpu_torch.core.ring import batch_ring_state
    from cityflow_tpu_torch.engine import Engine
    from cityflow_tpu_torch.tools import bench
    from cityflow_tpu_torch.tools.scenario import mixed_templates, prepare
    cfg = os.path.join(HERE, "benchmarks", "config_30x30.json")
    warmup = cs.WARMUP
    if path == "mixed":
        cfg = prepare(cfg, name="config_30x30_mixed",
                      templates=mixed_templates(os.path.join(
                          HERE, "tests", "fixtures", "flow_2x2_mixed.json")))
    elif path == "lc":
        cfg = prepare(os.path.join(HERE, "benchmarks",
                                   "config_30x30_lc.json"))
        warmup = cs.LC_WARMUP
    else:
        cfg = prepare(cfg)
    if path == "engine":
        eng = Engine(cfg, exact=False,
                     spawn_horizon=cs.RING_ENGINE_WARMUP + 16)
        for _ in range(cs.RING_ENGINE_WARMUP):
            eng.next_step()
        sim = eng._ring.sim
        return sim, batch_ring_state(sim.state, 1)
    args = bench.parser().parse_args(
        ["--config", cfg, "--batch", str(BATCH), "--warmup",
         str(warmup), "--window", "0", "--steps", "1", "--lane-slots",
         "0" if path == "mixed" else "40"])
    r = bench.run_ring(args, compile_scenario(cfg), BATCH)
    return r["sim"], r["state"]


def r2_rows(path, other, zero, reps):
    """R2's exits call of one more step of the path: held equal to the
    plain version and to the other checkout's, then A B B A and the
    split of both."""
    import chip_smoke as cs
    from cityflow_tpu_torch.kernels import ring_exits as r2
    mine_zero, mine_shim = _shim(r2._lib.lib())
    sim, state = ring_state(path)
    (a, k), = cs.record_ring_calls(sim, state)["ring_exits"]
    del sim, state
    setup = lambda: a[:3] + (cs.exits_copy(a[3]),)
    got = r2.ring_exits(*setup())
    err, nbit = cs._ring_compare("ring_exits", got,
                                 r2.ring_exits_plain(*setup()))
    theirs = other.ring_exits(*setup())
    err2, nbit2 = cs._ring_compare("ring_exits", got, theirs)
    inplace, copying = cs.exits_work(a, got)
    del got, theirs
    print(f"[{path}] ring_exits equal to the plain version (max_abs_err="
          f"{err} not_bitwise={nbit}) and to the other checkout's "
          f"({err2}, {nbit2})", flush=True)
    orig = r2._lib
    r2._lib = mine_shim
    try:
        other_ms, ms = abba(lambda x: other.ring_exits(*x),
                            lambda x: r2.ring_exits(*x), reps, setup)
        row = dict(call="ring_exits", B=a[2].n_l.shape[-1],
                   other_ms=other_ms, ms=ms,
                   bound_ms=bound(inplace, 0),
                   copying_bound_ms=bound(copying, 0), split={})
        for part, fields in SPLIT.items():
            mine_zero.zero = zero.zero = fields
            o, m = abba(lambda x: other.ring_exits(*x),
                        lambda x: r2.ring_exits(*x), reps, setup)
            row["split"][part] = dict(other_ms=o, ms=m)
    finally:
        r2._lib = orig
        mine_zero.zero = zero.zero = ()
    return [row]


def o2_rows(other, reps):
    """O2 in both modes on the [rl] state: held bitwise to the plain
    version and to the other checkout's, then A B B A."""
    import chip_smoke as cs
    from cityflow_tpu_torch.kernels import lane_stats as o1
    from cityflow_tpu_torch.kernels import phase_pressure as o2
    from cityflow_tpu_torch.tools.scenario import prepare
    _, _, env = cs.run_rl(prepare(os.path.join(HERE, "benchmarks",
                                               "config_30x30.json")),
                          BATCH, cs.RL_WARMUP, cs.STEPS)
    st, tabs, cfg = env.state, env.sim.tables, env.sim.cfg
    P, I = env._max_phases, cfg.I
    w = o1.lane_waiting(st.l_speed, st.n_l)
    rows = []
    for features in (False, True):
        a = (w, tabs, P, I, features)
        mine = o2.phase_pressure(*a)
        for g_, w_, o_ in zip(mine, o2.phase_pressure_plain(*a),
                              other.phase_pressure(*a)):
            assert cs.bitwise_equal(g_, w_), "O2 differs from the plain"
            assert cs.bitwise_equal(g_, o_), "O2 differs from the other"
        other_ms, ms = abba(lambda: other.phase_pressure(*a),
                            lambda: o2.phase_pressure(*a), reps)
        rows.append(dict(call="phase_pressure" + ("@features" * features),
                         B=w.shape[-1], P=P, other_ms=other_ms, ms=ms))
    return rows


def seeded_cases():
    """O2's and R2's seeded cases, kernel against plain version."""
    import chip_smoke as cs
    from cityflow_tpu_torch.kernels import phase_pressure, ring_exits
    from cityflow_tpu_torch.tools import kernel_cases as kc
    n = 0
    for name, case in kc.pressure_cases():
        for features in (False, True):
            a = kc.pressure_args(case, "cuda")
            _, bad = cs._bitwise(
                name, phase_pressure.phase_pressure(*a, features=features),
                phase_pressure.phase_pressure_plain(*a, features=features))
            assert bad == 0, f"phase_pressure[{name}]: {bad} differ"
        n += 1
    for name, case in kc.exits_cases():
        a = kc.exits_args(case, "cuda")
        got = ring_exits.ring_exits(*a)
        assert got["dis_l"] is a[3]["new_dis_l"]
        cs.check_exits_case(name, got, ring_exits.ring_exits_plain(
            *kc.exits_args(case, "cuda")))
        n += 1
    print(f"[cases] O2 / R2 seeded cases: {n} equal", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout of the commit to compare with")
    ap.add_argument("--paths", default="main,mixed,rl")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        sys.exit("time_exits_pressure: no CUDA device")
    import chip_smoke as cs
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    res = dict(card=smi, calls=[], ptxas=ptxas_lines(KERNELS))
    for line in res["ptxas"]:
        print(f"[ptxas] {line}", flush=True)
    seeded_cases()
    mods, zero, res["other_ptxas"] = other_kernels(
        os.path.abspath(args.parent))
    for path in filter(None, args.paths.split(",")):
        rows = o2_rows(mods["phase_pressure"], args.reps) \
            if path == "rl" else r2_rows(path, mods["ring_exits"], zero,
                                         args.reps)
        for row in rows:
            row["path"] = path
            res["calls"].append(row)
            print(f"[{path}] " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
