"""L1 lc_signal: the plain version against a numpy walk of the reference's
rule, on the seeded edge cases of cityflow_tpu_torch/tools/kernel_cases.py
(the cases chip_smoke.py holds the CUDA kernel to on the card, bit for
bit).

The walk restates SimpleLaneChange::makeSignal, estimateGap,
updateLeaderAndFollower and the gap validity (lanechange.cpp:27-60,
151-220, lanechange.h:80) in float32, one operation at a time in the
reference's order, column by column: a vehicle's leader in a neighbour
lane is the last of that lane's vehicles, front to back, whose distance
is >= its own (Lane::getVehicleAfterDistance; in a lane out of order, the
slot before the count of its vehicles at >= that distance), its follower
the next one; with
no leader there, the target lane's out-link ring tails are scanned in
order for the nearest (a strict minimum), and one closer than its own
length shortens the gap. A template index outside [0, TP) reads zeros.

Values are compared as bits (+0.0 and -0.0 apart; a NaN matches a NaN).
"""

import numpy as np
import pytest
import torch

from cityflow_tpu_torch.kernels import lc_signal
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_follow_cases import (P_LEN, P_MAXNEGACC, P_MAXSPEED,
                                     _bits_equal, _param)

F = np.float32
COOLING = F(3.0)


def _mine(c, p, b):
    """(len, maxNegAcc, expected gap, 1.5 len) of each slot of column
    (p, b): the config's scalars, or each row's template's."""
    p_len, p_neg, p_spd, interval = c["prm"]
    S = c["dis"].shape[0]
    if c["tpl"] is None:
        full = lambda v: np.full(S, F(v))
        return (full(p_len), full(p_neg),
                full(2 * p_len + 4 * interval * p_spd), full(1.5 * p_len))
    idx = c["tpl"][:, p, b]
    ln = _param(c["table"], idx, P_LEN)
    return (ln, _param(c["table"], idx, P_MAXNEGACC),
            F(2) * ln + F(4 * interval) * _param(c["table"], idx,
                                                 P_MAXSPEED),
            F(1.5) * ln)


def _neighbour(c, q, b, d):
    """Leader (slot cnt - 1) and follower (slot cnt) in lane column q of
    env b of each distance in d: cnt counts the vehicles at >= d
    (Lane::getVehicleAfterDistance on the lane's front-to-back list; a
    lane out of order is held to the same count)."""
    S = len(d)
    n = int(c["n_l"][q, b]) if q >= 0 else 0
    col = c["dis"][:n, q, b] if n else np.zeros(0, F)
    cnt = (col[None, :] >= d[:, None]).sum(1).astype(np.int32)
    r = dict(cnt=cnt, lead=cnt > 0, foll=cnt < n)
    li, fi = np.maximum(cnt - 1, 0), np.minimum(cnt, S - 1)
    z = np.zeros(S, F)
    if n:
        r["lead_dis"] = np.where(r["lead"], c["dis"][li, q, b], z)
        r["foll_dis"] = np.where(r["foll"], c["dis"][fi, q, b], z)
        r["foll_spd"] = np.where(r["foll"], c["speed"][fi, q, b], z)
    else:
        r["lead_dis"] = r["foll_dis"] = r["foll_spd"] = z
    if c["tpl"] is not None:
        r["lead_len"] = np.where(r["lead"], _param(
            c["table"], c["tpl"][li, max(q, 0), b], P_LEN), z)
        r["foll_neg"] = np.where(r["foll"], _param(
            c["table"], c["tpl"][fi, max(q, 0), b], P_MAXNEGACC), z)
    return r


def _walk(c):
    """plan, has_signal, gap_valid, dirc, tl_slot, ygap; and per slot
    whether the target side had no leader and an out-link tail was
    nearer than a vehicle length (the tail branch's short gap)."""
    S, N, B = c["dis"].shape
    M = c["rnrow"].shape[0]
    KOUT = c["olt_dis"].shape[0]
    outs = [np.zeros((S, N, B), t) for t in
            (bool, bool, bool, np.int32, np.int32, F)]
    short = np.zeros((S, N, B), bool)
    ln_len = c["ln_len"]
    s_idx = np.arange(S)
    tpl = c["tpl"] is not None
    for p in range(N):
        qo, qi = int(c["outer_src"][p]), int(c["inner_src"][p])
        lo = int(c["ln_llocal"][p])
        for b in range(B):
            ln, neg, expected, len15 = _mine(c, p, b)
            d, v = c["dis"][:, p, b], c["speed"][:, p, b]
            occ = s_idx < c["n_l"][p, b]
            shv, chv = c["sh"][:, p, b], c["chg"][:, p, b]
            lane_left = ln_len[p] - d
            no, ni = _neighbour(c, qo, b, d), _neighbour(c, qi, b, d)
            # makeSignal
            mk = occ & ~shv & ~chv & (c["now"][b] >= COOLING)
            hs = mk | (occ & ~shv & chv)
            cur = c["l_gap"][:, p, b]
            want = mk & (lane_left >= F(30)) & ~(cur > expected) \
                & ~(cur < len15)
            last = c["l_last"][:, p, b]
            row = lambda r: c["rnrow"][r, :, p, b] if 0 <= r < M \
                else np.full(S, -1)

            def estimate(nb, q):            # estimateGap: the leader's len
                l_len = nb["lead_len"] if tpl else ln
                return np.where(nb["lead"], (nb["lead_dis"] - d) - l_len,
                                (ln_len[q] if q >= 0 else F(0)) - d)
            outer_ok = want & (qo >= 0) & (last | (row(lo + 1) >= 0))
            outer_est = np.where(outer_ok, estimate(no, qo), F(0))
            new = np.where(outer_ok & (outer_est > cur + ln), 1, 0)
            inner_ok = want & (qi >= 0) & (last | (row(lo - 1) >= 0))
            inner_est = estimate(ni, qi)
            new = np.where(inner_ok & (inner_est > cur + ln)
                           & (inner_est > outer_est), -1, new)
            dc = np.where(chv, c["l_dir"][:, p, b], new).astype(np.int32)
            # updateLeaderAndFollower on the target side, slot by slot
            up = dc > 0
            T = {k: np.where(up, no[k], ni[k]) for k in no}
            lgap = np.where(T["lead"], (T["lead_dis"] - d)
                            - (T["lead_len"] if tpl else ln), lane_left)
            for s in np.nonzero(~T["lead"])[0]:
                tq = qo if up[s] else qi
                best = F(np.inf)
                for k in range(KOUT):
                    if tq < 0 or not c["olt_ex"][k, tq, b]:
                        continue
                    c_len = c["olt_len"][k, tq, b] if tpl else ln[s]
                    cgap = c["olt_dis"][k, tq, b] + lane_left[s]
                    if cgap < best:
                        if cgap < c_len:
                            lgap[s] = lane_left[s] - (c_len - cgap)
                            short[s, p, b] = True
                        best = cgap
            fgap = np.where(T["foll"], (d - T["foll_dis"]) - ln, F(np.inf))
            min_brake = F(0.5) * v * v / neg
            f_neg = T["foll_neg"] if tpl else neg
            safe = np.where(T["foll"], F(0.5) * T["foll_spd"]
                            * T["foll_spd"] / f_neg, F(0))
            for o, val in zip(outs, (
                    occ & ~shv & ((hs & (dc != 0)) | chv), hs,
                    (lgap >= min_brake) & (fgap >= safe), dc,
                    T["cnt"] - 1, fgap - safe)):
                o[:, p, b] = val
    return tuple(outs), short


@pytest.mark.parametrize("name", kc.SIGNAL_CASES)
def test_signal_plain_matches_reference_walk(name):
    case = kc.signal_case(name)
    a, k = kc.signal_args(case, "cpu")
    got = lc_signal.lc_signal(*a, **k)
    with np.errstate(all="ignore"):
        want, _ = _walk(case)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _bits_equal(g.numpy(), w) == 0, (name, i)


def test_signal_cases_reach_their_edges():
    """The set reaches the edges kernel_cases.py names: neighbour columns
    out of order (the kernel's linear count) and in order (its binary
    search), NaN and -0.0 distances, empty neighbour columns, rows past
    n_l, the out-link tail branch with a short gap, templates with indices
    outside [0, TP), signals in both directions and gaps valid and not;
    at B = 1, 3, 128 and 130, S = 1, 40 and a ring whose staged columns
    do not fit the shared memory at 32 envs a block."""
    seen = dict(B=set(), S=set(), linear=0, binary=0, nan=0, negz=0,
                empty=0, past=0, short=0, tpl=0, up=0, down=0, gv=0,
                not_gv=0)
    for name, c in kc.signal_cases():
        S, N, B = c["dis"].shape
        seen["B"].add(B)
        seen["S"].add(S)
        T = {k: torch.as_tensor(c[k]) for k in ("inner_src", "outer_src")}
        reads, linear = lc_signal.unsorted_reads(
            torch.as_tensor(c["dis"]), torch.as_tensor(c["n_l"]), T)
        seen["linear"] += linear
        seen["binary"] += reads - linear
        occ = np.arange(S)[:, None, None] < c["n_l"][None]
        seen["nan"] += int((occ & np.isnan(c["dis"])).any())
        seen["negz"] += int((occ & (c["dis"] == 0)
                             & np.signbit(c["dis"])).any())
        has = c["outer_src"] >= 0
        seen["empty"] += int((c["n_l"][c["outer_src"][has]] == 0).any())
        seen["past"] += int((~occ).any())
        with np.errstate(all="ignore"):
            (plan, _, gval, dirc, _, _), short = _walk(c)
        seen["short"] += int(short.any())
        seen["up"] += int((plan & (dirc > 0)).any())
        seen["down"] += int((plan & (dirc < 0)).any())
        seen["gv"] += int((plan & gval).any())
        seen["not_gv"] += int((plan & ~gval).any())
        if c["tpl"] is not None:
            TP = c["table"].shape[0]
            seen["tpl"] += int((occ & ((c["tpl"] < 0)
                                       | (c["tpl"] >= TP))).any())
    assert seen["B"] == {1, 3, 128, 130}
    # S = 200: 2 columns x 200 rows x 32 envs x 4 bytes > 48 KB
    assert {1, 40} <= seen["S"] and max(seen["S"]) * 2 * 32 * 4 > 48 * 1024
    for k in ("linear", "binary", "nan", "negz", "empty", "past", "short",
              "up", "down", "gv", "not_gv"):
        assert seen[k] > 0, k
    assert seen["tpl"] >= 3
