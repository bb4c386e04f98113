#!/usr/bin/env python3
"""L1 lc_signal and L3 lc_insert on the card: every L1 and L3 call of one
step of the lane-change ring paths, each held against its plain version
and then timed beside it and its bound, after both kernels' seeded edge
cases (tools/kernel_cases.py), each also timed.

    python -m cityflow_tpu_torch.tools.time_signal_insert \
        [--paths lc,mixed-lc] [--reps 20] [--out FILE]

Run from the root of the repo (it imports chip_smoke.py's timing, compare
and bound helpers). lc and mixed-lc are time_follow_caps.py's paths (one
env through chip_smoke.py's warm-up and timed steps, copied into a batch
of 128, one more batched step recorded, every argument copied before the
call: L3 writes the lane leaves in place after L1 reads them, and its
own). L3 writes its state in place, so each of its calls (a check or a
timed call) runs on a fresh copy of the recorded state, untimed. Each
call is timed (CUDA events) in the order kernel, plain, kernel. It prints
the ptxas lines of both kernels' functions, how many neighbour columns
each L1 call read by its linear count, a line per call and, last, one
JSON object with every reading, each call's bound and the card's name
and power limit.

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
from cityflow_tpu_torch.tools.time_receive_admit import bound, ptxas_lines

KERNELS = ("lc_select_kernel", "lc_start_kernel", "lc_insert_kernel",
           "lc_signal_kernel")


def ring_rows(path, reps):
    """Every L1 and L3 call of one batched step of the ring path `path`."""
    import chip_smoke as cs
    from cityflow_tpu_torch.core import ring_lc
    from cityflow_tpu_torch.kernels import lc_insert as l3
    from cityflow_tpu_torch.kernels import lc_signal as l1
    rows = []
    for n, a, k in record_calls(path, ring_lc, ("lc_signal", "lc_insert"),
                                copy=True):
        tpl = k.get("tpl") is not None if n == "lc_signal" \
            else "tpl" in a[0]
        label = n + ("@tpl" if tpl else "")
        if n == "lc_signal":
            fn = lambda: l1.lc_signal(*a, **k)
            plain = lambda: l1.lc_signal_plain(*a, **k)
            _, bad = cs._bitwise(label, fn(), plain())
            nbytes, nops = (cs.tpl_work if tpl else cs.lc_work)(n, a, k)
            ms = [cs.time_cuda(fn, reps)]
            plain_ms = cs.time_cuda(plain, reps)
            ms.append(cs.time_cuda(fn, reps))
            reads, linear = l1.unsorted_reads(a[0], a[2], a[12])
            extra = dict(reads=reads, linear=linear)
        else:
            _, bad = cs._bitwise(label, cs.lc_call(l3.lc_insert, n, a, k),
                                 cs.lc_call(l3.lc_insert_plain, n, a, k))
            nbytes, nops = cs.insert_work(a), 0
            first, plain_ms = cs.time_insert(l3.lc_insert,
                                             l3.lc_insert_plain, a, reps)
            ms = [first, cs.time_insert(l3.lc_insert, None, a, reps)[0]]
            _, _, exs, _ = l3.insert_plan(a[0]["dis"], a[1], a[2], a[4],
                                          a[5], a[6])
            extra = dict(LCI=a[6], inserts=int(sum(int(e.sum())
                                                   for e in exs)))
        assert bad == 0, f"{label}: {bad} values not bitwise"
        rows.append(dict(call=label, S=a[0].shape[0] if n == "lc_signal"
                         else a[1].shape[0], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound(nbytes, nops), **extra))
    return rows


def case_rows(reps):
    """Both kernels on each seeded case: bit for bit against the plain
    version, then the kernel timed (L3 on a fresh copy each call)."""
    import chip_smoke as cs
    from cityflow_tpu_torch.kernels import lc_insert as l3
    from cityflow_tpu_torch.kernels import lc_signal as l1
    from cityflow_tpu_torch.tools import kernel_cases as kc
    rows = []
    for name, case in kc.insert_cases():
        setup = lambda: kc.insert_args(case, "cuda")
        _, bad = cs._bitwise(name, l3.lc_insert(*setup()),
                             l3.lc_insert_plain(*setup()))
        assert bad == 0, f"lc_insert[{name}]: {bad} values not bitwise"
        rows.append(dict(call=f"lc_insert[{name}]", ms=cs.time_cuda_fresh(
            setup, lambda x: l3.lc_insert(*x), reps)))
    for name, case in kc.signal_cases():
        a, k = kc.signal_args(case, "cuda")
        _, bad = cs._bitwise(name, l1.lc_signal(*a, **k),
                             l1.lc_signal_plain(*a, **k))
        assert bad == 0, f"lc_signal[{name}]: {bad} values not bitwise"
        rows.append(dict(call=f"lc_signal[{name}]", ms=cs.time_cuda(
            lambda: l1.lc_signal(*a, **k), reps)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="lc,mixed-lc")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        sys.exit("time_signal_insert: no CUDA device")
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
    for path in filter(None, args.paths.split(",")):
        for row in ring_rows(path, args.reps):
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
