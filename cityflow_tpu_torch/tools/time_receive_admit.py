#!/usr/bin/env python3
"""L2 lc_receive and G12 admit_heads on the card: every L2 call of one step
of the lane-change ring paths and every G12 call of one gen-1 step, each
held against its plain version and then timed beside it and its bound (G12
also beside the one scatter_reduce("amin") that chip_smoke.py times as its
yardstick), after both kernels' seeded edge cases (tools/kernel_cases.py).

    python -m cityflow_tpu_torch.tools.time_receive_admit \
        [--paths lc,mixed-lc,gen1-batch,gen1] [--reps 20] [--out FILE]

Run from the root of the repo (it imports chip_smoke.py's timing, compare
and bound helpers). lc and mixed-lc are time_follow_caps.py's paths (one
env through chip_smoke.py's warm-up and timed steps, copied into a batch
of 128, one more batched step recorded); gen1-batch is chip_smoke.py's
[gen1-batch] (the fast Engine's state after 300 steps in a batch of 128,
one more batched step); gen1 the exact Engine at one env (step 301). Each
call is timed (CUDA events, `reps` launches) in the order kernel, plain,
kernel. It prints a line per call and, last, one JSON object with every
reading, each call's bound and the card's name and power limit.

A compile-time alternative of a kernel is timed as with
time_follow_caps.py: run this tool in the tree and in an archived copy
with the constant changed, in turns in one call.
"""

import argparse
import json
import os
import sys

import torch

from cityflow_tpu_torch.tools.time_follow_caps import HERE, record_calls

BATCH = 128
GEN1_WARMUP = 300
GEN1_CFG = os.path.join("benchmarks", "config_30x30.json")


def ring_rows(path, reps):
    """Every L2 call of one batched step of the ring path `path`."""
    import chip_smoke as cs
    from cityflow_tpu_torch.core import ring_lc
    from cityflow_tpu_torch.kernels import lc_receive as l2
    rows = []
    for _, a, k in record_calls(path, ring_lc, ("lc_receive",), copy=True):
        tpl = k.get("tpl") is not None
        label = "lc_receive" + ("@tpl" if tpl else "")
        fn = lambda: l2.lc_receive(*a, **k)
        plain = lambda: l2.lc_receive_plain(*a, **k)
        err, nbit = cs._compare(label, fn(), plain(), 1e-5)
        nbytes, nops = (cs.tpl_work if tpl else cs.lc_work)(
            "lc_receive", a, k)
        ms = [cs.time_cuda(fn, reps)]
        plain_ms = cs.time_cuda(plain, reps)
        ms.append(cs.time_cuda(fn, reps))
        rows.append(dict(call=label, S=a[0].shape[0], ms=ms,
                         plain_ms=plain_ms, max_abs_err=err,
                         not_bitwise=nbit, bound_ms=bound(nbytes, nops)))
    return rows


def bound(nbytes, nops, flops=None):
    import chip_smoke as cs
    return max(nbytes / cs.H100_BYTES_PER_S,
               nops / (flops or cs.H100_F32_FLOPS)) * 1e3


def gen1_rows(path, reps):
    """Every G12 call of one gen-1 step: `gen1-batch` the fast step at
    BATCH envs from the fast Engine's state after GEN1_WARMUP steps,
    `gen1` the exact Engine's next step at one env."""
    import chip_smoke as cs
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.core.state import pad_state
    from cityflow_tpu_torch.engine import Engine
    from cityflow_tpu_torch.parallel.batch import (
        init_batch_state, make_batched_step)
    from cityflow_tpu_torch.tools.scenario import prepare
    cfg_path = prepare(os.path.join(HERE, GEN1_CFG))
    fast = path == "gen1-batch"
    kw = dict(exact=False, backend="gen1") if fast else {}
    eng = Engine(cfg_path, spawn_horizon=GEN1_WARMUP + 16, **kw)
    for _ in range(GEN1_WARMUP):
        eng.next_step()
    mod = kernels.MODULES["admit_heads"]
    orig = mod.admit_heads
    calls = []

    def rec(*a):
        calls.append(a)
        return orig(*a)
    mod.admit_heads = rec
    try:
        if fast:
            cfg, net, spawn = eng.cfg, eng._net_dev, eng._spawn_dev
            stb = init_batch_state(cfg, pad_state(eng.state,
                                                  cfg.max_vehicles), BATCH)
            del eng
            # the batched step writes its state (donated): it steps a copy
            make_batched_step(net, cfg, with_obs=False)(cs.fresh(stb), spawn)
        else:
            eng.next_step()
        torch.cuda.synchronize()
    finally:
        mod.admit_heads = orig
    rows = []
    for a in calls:
        label = "admit_heads" + ("@batch" if fast else "")
        fn = lambda: mod.admit_heads(*a)
        plain = lambda: mod.admit_heads_plain(*a)
        out = fn()
        _, bad = cs._bitwise(label, out, plain())
        assert bad == 0, f"{label}: {bad} values not bitwise"
        nbytes, nops = cs.gen1_work("admit_heads", a, {}, out)
        ms = [cs.time_cuda(fn, reps)]
        plain_ms = cs.time_cuda(plain, reps)
        ms.append(cs.time_cuda(fn, reps))
        rows.append(dict(
            call=label, B=a[0].shape[0], V=a[0].shape[1], ms=ms,
            plain_ms=plain_ms, library_ms=cs.heads_amin_ms(a, reps),
            waiting=int((a[0] & ~a[1]).sum()),
            bound_ms=bound(nbytes, nops,
                           cs.H100_F32_FLOPS if fast else cs.H100_F64_FLOPS)))
    return rows


def ptxas_lines(keys=("lc_receive_kernel", "admit_slots", "admit_lanes")):
    """ptxas' report (registers, stack frame, spills) of the kernels whose
    mangled names hold one of `keys`, from the library's build log."""
    from cityflow_tpu_torch.kernels import _lib
    path = _lib.lib()._name + ".ptxas.txt"
    out, keep = [], False
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if "entry function" in line or "Function properties" in line:
                keep = any(k in line for k in keys)
            if keep and ("entry function" in line or "registers" in line
                         or "spill" in line):
                out.append(line.strip())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="lc,mixed-lc,gen1-batch,gen1")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        sys.exit("time_receive_admit: no CUDA device")
    import chip_smoke as cs
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    res = dict(card=smi, calls=[], ptxas=ptxas_lines())
    for line in res["ptxas"]:
        print(f"[ptxas] {line}", flush=True)
    cs.check_kernel_cases()
    for path in filter(None, args.paths.split(",")):
        rows = gen1_rows(path, args.reps) if path.startswith("gen1") \
            else ring_rows(path, args.reps)
        for row in rows:
            row["path"] = path
            res["calls"].append(row)
            print(f"[{path}] " + " ".join(
                f"{k}={v}" for k, v in row.items() if k != "path"),
                flush=True)
        torch.cuda.empty_cache()
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
