#!/usr/bin/env python3
"""K3 car_follow and K2 cross_caps on the card: every call of one ring
step, each timed beside its plain version and its bound, and the division
and square-root subroutine calls that each kernel's SASS makes.

    python -m cityflow_tpu_torch.tools.time_follow_caps \
        [--paths main,mixed] [--reps 20] [--out FILE] [--sass [OLD_CSRC]]

Run from the root of the repo (it imports chip_smoke.py's timing, bitwise
and bound helpers). For each path (PATHS: main, benchmarks/config_30x30.json
at B=128 with 40 lane slots; mixed, the same grid with flow i given
template i mod 3 of tests/fixtures/flow_2x2_mixed.json and build_sim's
lane slots; lc and mixed-lc, the same on benchmarks/config_30x30_lc.json)
one env runs the path's warm-up and timed steps of chip_smoke.py, is
copied into the batch, and one more batched step records every K2 and K3
call. Each call is checked bit for bit against its plain version, then
timed (CUDA events, `reps` launches) in the order kernel, plain, kernel,
so that the kernel's two readings bracket the plain one. It prints a line
per call and, last, one JSON object with every reading, each call's bound
and the card's name and power limit.

To time a compile-time alternative of a kernel (a constant of its source,
such as K3's env width or blocks per SM), unpack a copy of the tree (git
archive) into a git-ignored directory, change the constant there, and
run this tool in the tree and in the copy in turns in one call, A B B A:
each tree builds its own library.

--sass compiles csrc/car_follow.cu and csrc/cross_caps.cu, and the same
two files under OLD_CSRC (an earlier version of the sources) when given,
to cubins (nvcc, the library's flags) and counts in each kernel the calls
of nvdisasm's listing by target: the IEEE division and square-root slow
paths and 64-bit integer division are subroutines there.
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BATCH = 128
# name -> (config, templates, lane slots, steps of one env before the
# recorded step: the ring path's warm-up and its 40 timed steps)
PATHS = {
    "main": ("config_30x30.json", False, 40, 8 + 40),
    "mixed": ("config_30x30.json", True, None, 8 + 40),
    "lc": ("config_30x30_lc.json", False, 40, 1960 + 40),
    "mixed-lc": ("config_30x30_lc.json", True, None, 1960 + 40),
}
FOLLOW_CAPS = ("car_follow", "cross_caps")


def call_label(name, a, k):
    """The call site: K3's lane / link rows (ring-leader mode) or its
    approach rows (isr, min_chain), K2's link or approach rows."""
    if name == "car_follow":
        r = k.get("ring")
        site = r.kind if r is not None else f"approach-mode{a[0]}"
        return f"car_follow@{site}" + ("+yield" if "v_yield" in k else "")
    return "cross_caps@" + ("link" if torch.is_tensor(a[2]) else "approach")


def record_calls(path, module=None, names=FOLLOW_CAPS, copy=False):
    """Every call of the wrappers `names` of `module` (default: K2 and K3
    of core/ring.py) in one batched step of `path` (a key of PATHS) after
    its warm-up steps of one env: [(name, args, kwargs)]. The arguments
    are kept by reference (as the step passed them, views sharing their
    storage): nothing in the step writes K2's and K3's after the call (R3
    admits in place before they run). The lane-change kernels' are not
    so: L3 writes the lane leaves in place after L1 and L2 read them, and
    its own; with `copy` every tensor argument but the net's tables is
    kept as a copy taken before the call."""
    from cityflow_tpu_torch import ring_sim
    from cityflow_tpu_torch.compiler.net import compile_scenario
    from cityflow_tpu_torch.core import ring as ring_mod
    from cityflow_tpu_torch.tools.scenario import mixed_templates, prepare
    config, tpl, sl, warmup = PATHS[path]
    bench = os.path.join(HERE, "benchmarks", config)
    if tpl:
        fix = os.path.join(HERE, "tests", "fixtures", "flow_2x2_mixed.json")
        cfg = prepare(bench, name=config[:-5] + "_mixed",
                      templates=mixed_templates(fix))
    else:
        cfg = prepare(bench)
    sim = ring_sim.build_sim(compile_scenario(cfg), horizon=warmup + 8,
                             sl=sl)
    one = ring_mod.batch_ring_state(sim.state, 1)
    for _ in range(warmup):
        one = ring_mod.ring_step_batched(sim.tables, sim.cfg, one, sim.q)
    st = ring_mod.batch_ring_state(one.map(lambda x: x[..., 0]), BATCH)
    del one
    calls = []
    module = module or ring_mod
    orig = {n: getattr(module, n) for n in names}

    keep = {id(v) for v in sim.tables.values()}

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x if id(x) in keep else x.clone()
        if x is sim.tables:
            return x
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(clone(v) for v in x)
        return x

    def rec(n):
        def fn(*a, **k):
            calls.append((n, *clone((a, k))) if copy else (n, a, k))
            return orig[n](*a, **k)
        return fn

    try:
        for n in names:
            setattr(module, n, rec(n))
        ring_mod.ring_step_batched(sim.tables, sim.cfg, st, sim.q)
        torch.cuda.synchronize()
    finally:
        for n, f in orig.items():
            setattr(module, n, f)
    return calls


def time_calls(calls, reps):
    """[{call, ms: [kernel, kernel], plain_ms, bound_ms}], each call
    checked bit for bit against its plain version first."""
    import chip_smoke as cs
    from cityflow_tpu_torch import kernels
    out = []
    for n, a, k in calls:
        mod = kernels.MODULES[n]
        fn, plain = getattr(mod, n), getattr(mod, n + "_plain")
        label = call_label(n, a, k)
        _, bad = cs._bitwise(label, fn(*a, **k), plain(*a, **k))
        assert bad == 0, f"{label}: {bad} values not bitwise"
        nbytes, nops = cs.k3_work(a, k) if n == "car_follow" \
            else cs.cross_caps_work(a, k)
        ms = [cs.time_cuda(lambda: fn(*a, **k), reps)]
        plain_ms = cs.time_cuda(lambda: plain(*a, **k), reps)
        ms.append(cs.time_cuda(lambda: fn(*a, **k), reps))
        out.append(dict(call=label, ms=ms, plain_ms=plain_ms,
                        bound_ms=max(nbytes / cs.H100_BYTES_PER_S,
                                     nops / cs.H100_F32_FLOPS) * 1e3))
    return out


def sass_calls(csrc):
    """{kernel function: {call target: count}} of car_follow.cu and
    cross_caps.cu under `csrc`, compiled to cubins as kernels/_lib builds
    them, from nvdisasm's listing (cuobjdump -sass when nvdisasm is
    missing: targets are then addresses)."""
    from cityflow_tpu_torch.kernels import _lib
    nvcc = _lib._nvcc()
    bindir = os.path.dirname(nvcc)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("car_follow.cu", "cross_caps.cu"):
            cub = os.path.join(tmp, src + ".cubin")
            subprocess.run([nvcc, *_lib.ARCH_FLAGS, "-std=c++17", "-O3",
                            "--fmad=false", "-cubin", "-o", cub,
                            os.path.join(csrc, src)], check=True,
                           capture_output=True)
            nvd = os.path.join(bindir, "nvdisasm")
            if os.path.exists(nvd):
                text = subprocess.run([nvd, "-c", cub], check=True,
                                      capture_output=True, text=True).stdout
            else:
                text = subprocess.run(
                    [os.path.join(bindir, "cuobjdump"), "-sass", cub],
                    check=True, capture_output=True, text=True).stdout
            fn = None
            for line in text.splitlines():
                m = re.search(r"\.text\.(\S+):|Function : (\S+)", line)
                if m:
                    fn = (m.group(1) or m.group(2)).rstrip(":")
                    continue
                m = re.search(r"\bCALL\.\S*\s+(.*?)\s*;", line)
                if m and fn is not None:
                    tgt = re.sub(r"[`()]", "", m.group(1)).strip()
                    tgt = re.sub(r"\$__internal_\d+_\$", "", tgt)
                    d = out.setdefault(fn, collections.Counter())
                    d[tgt] += 1
    return {f: dict(c) for f, c in out.items()
            if not f.startswith("$__internal")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="main,mixed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", nargs="?", const="", default=None,
                    metavar="OLD_CSRC")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        sys.exit("time_follow_caps: no CUDA device")
    import chip_smoke as cs
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    res = dict(card=smi, calls=[])
    if args.sass is not None:
        from cityflow_tpu_torch.kernels import _lib
        res["sass"] = {"new": sass_calls(_lib.CSRC)}
        if args.sass:
            res["sass"]["old"] = sass_calls(args.sass)
        for k, v in res["sass"].items():
            for f, c in sorted(v.items()):
                print(f"[sass] {k} {f}: {c}", flush=True)
    for path in filter(None, args.paths.split(",")):
        calls = record_calls(path)
        for row in time_calls(calls, args.reps):
            row["path"] = path
            res["calls"].append(row)
            print(f"[{path}] {row['call']}: ms={row['ms']} "
                  f"plain_ms={row['plain_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.4f}", flush=True)
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
