"""L2 lc_receive: the plain version against a numpy walk of the
reference's rule, on the seeded edge cases of
cityflow_tpu_torch/tools/kernel_cases.py (the cases chip_smoke.py holds the
CUDA kernel to on the card).

The walk restates Vehicle::receiveSignal and yieldSpeed (vehicle.cpp:391-401,
lanechange.cpp:186-206) column by column: a receiver, an occupied slot,
collects every sender of its inner lane (direction +1) and its outer lane
(direction -1) whose target leader slot (tl_slot) or follower slot
(tl_slot + 1) it is, and keeps the first of them, in inner-then-outer,
slot-ascending order, that holds the highest priority; it receives the
signal unless it is changing or holds a signal of its own of no lower
priority, and yields (noCollisionSpeed, float32, one operation at a time)
only in the follower role. The plain version keeps its sender by a chain
of strict `>` replacements instead.

Values are compared as bits, with test_torch_follow_cases.py's two
exceptions: the plain version takes numpy's correctly rounded square root,
and a NaN matches a NaN.

Also here: the kernel's precondition, that L1 sets plan on occupied rows
only, on the lane-change fixture's own L1 calls.
"""

import os

import numpy as np
import pytest
import torch

from cityflow_tpu_torch.kernels import lc_receive
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_follow_cases import (  # noqa: F401 (ieee_sqrt: a fixture)
    P_MAXNEGACC, _bits_equal, _ncs, _param, ieee_sqrt)

F = np.float32
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
# the receiver slots one chunk of the kernel's shared table holds
RC_TABLE = 48


def _senders(c, p, b):
    """(slot, column) of the senders aimed at lane p's column in env b:
    its inner column's plan rows of direction +1, then its outer column's
    of direction -1, slots ascending."""
    out = []
    for q, want in ((c["inner_src"][p], 1), (c["outer_src"][p], -1)):
        if q < 0:
            continue
        t = np.nonzero(c["plan"][:, q, b] & (c["dirc"][:, q, b] == want))[0]
        out += [(int(s), int(q)) for s in t]
    return out


def _neg(c, idx):
    """maxNegAcc at template indices idx (the scalar without templates)."""
    if c["tpl"] is None:
        return np.full(np.shape(idx), F(c["prm"][0]))
    return _param(c["table"], idx, P_MAXNEGACC)


def _walk(c):
    """yv, do_change and each receiver's kept sender ((S, N, B) int: its
    slot * 2 + side, -1 none) by the reference's rule."""
    S, N, B = c["plan"].shape
    dt = F(c["prm"][1])
    tpl = c["tpl"]
    yv = np.full((S, N, B), F(100.0))
    kept = np.full((S, N, B), -1)
    received = np.zeros((S, N, B), bool)
    my = np.arange(S)
    for p in range(N):
        for b in range(B):
            snd = _senders(c, p, b)
            if not snd:
                continue
            t = np.array([s for s, _ in snd])
            q = np.array([q for _, q in snd])
            side = (q != c["inner_src"][p]).astype(int)
            tl = c["tl_slot"][t, q, b].astype(np.int64)
            pri = c["pri"][t, q, b].astype(np.int64)
            as_l = tl[None, :] == my[:, None]
            as_f = tl[None, :] + 1 == my[:, None]
            cand = as_l | as_f                            # (S, senders)
            best = np.where(cand, pri[None, :], np.iinfo(np.int64).min)
            top = best.max(1)
            got = cand.any(1)
            # the first candidate holding the top priority
            first = np.argmax(cand & (best == top[:, None]), axis=1)
            occ = my < c["n_l"][p, b]
            own = c["pri"][:, p, b].astype(np.int64)
            rec = occ & ~c["chg"][:, p, b] & got \
                & ~(c["hsig"][:, p, b] & ~(top > own))
            received[:, p, b] = rec
            kept[:, p, b] = np.where(got, t[first] * 2 + side[first], -1)
            role_f = as_f[my, first] & ~as_l[my, first]
            yld = rec & role_f
            if not yld.any():
                continue
            s = my[yld]
            st, sq = t[first[s]], q[first[s]]
            s_neg = _neg(c, None if tpl is None else tpl[st, sq, b])
            m_neg = _neg(c, None if tpl is None else tpl[s, p, b])
            with np.errstate(all="ignore"):
                v = _ncs(c["speed"][st, sq, b], s_neg, c["speed"][s, p, b],
                         m_neg, c["ygap"][st, sq, b], dt, F(0))
            yv[s, p, b] = np.where(v < F(0), F(100.0), v)
    do_change = c["plan"] & c["hsig"] & ~received & ~c["chg"] & c["gval"] \
        & (c["dirc"] != 0)
    return yv, do_change, kept, received


@pytest.mark.parametrize("name", kc.RECEIVE_CASES)
def test_receive_plain_matches_reference_walk(name, ieee_sqrt):
    case = kc.receive_case(name)
    a, k = kc.receive_args(case, "cpu")
    got = lc_receive.lc_receive(*a, **k)
    yv, do_change, _, received = _walk(case)
    assert _bits_equal(got[0].numpy(), yv) == 0, name
    assert _bits_equal(got[1].numpy(), do_change) == 0, name
    # the walk yields somewhere in every case with a receiver
    assert (yv < 100).any() or not received.any(), name


def test_receive_cases_reach_their_edges():
    """Each case holds the edges its generator names; the set covers B = 1,
    3, 128 and 130, S = 1, 40 and rings longer than the kernel's table, and
    the template mode."""
    seen = {"B": set(), "S": set(), "tpl": 0}
    for name, c in kc.receive_cases():
        S, N, B = c["plan"].shape
        seen["B"].add(B)
        seen["S"].add(S)
        occ = np.arange(S)[:, None, None] < c["n_l"][None]
        # the kernel's precondition: plan on occupied rows only
        assert not (c["plan"] & ~occ).any(), name
        assert (c["inner_src"] < 0).any() and (c["outer_src"] < 0).any()
        assert (c["n_l"] == 0).all(1).any() and (c["n_l"] == S).all(1).any()
        yv, _, kept, received = _walk(c)
        send = c["plan"] & (c["dirc"] != 0)
        tl = c["tl_slot"]
        assert (send & (tl == -1)).any(), name          # follower of slot 0
        if S > 1:
            assert (send & (tl == S - 1)).any(), name   # follower off the ring
        # the crowd: lane 5's receivers c and c + 1 are offered every
        # occupied row of column 6 at one priority, and keep the first
        p, cs = c["crowd"]
        crowded = 0
        for b in range(B):
            if c["n_l"][6, b] > 0:
                for s in (cs, cs + 1):
                    if s < min(S, c["n_l"][p, b]):
                        assert kept[s, p, b] == 0, (name, b, s)
                        crowded += 1
        assert crowded or B == 1, name
        # unoccupied receivers receive nothing
        assert not (received & ~occ).any(), name
        if S >= 40:
            # receivers kept a sender while changing, while holding a
            # signal of their own (received where the sender's priority is
            # higher, not where it ties); senders whose priorities differ
            # only in the high half, and negative priorities, are kept
            got = kept >= 0
            assert (got & occ & c["chg"]).any(), name
            assert (got & occ & c["hsig"] & received).any(), name
            assert (got & occ & c["hsig"] & ~received & ~c["chg"]).any()
            pri = c["pri"]
            hi = (pri & 0xFFFF) == 5
            assert (send & hi & (pri > 0)).any() and (send & (pri < 0)).any()
            assert (received & (yv < 100)).any(), name
        if S > RC_TABLE:
            # receivers past the first chunk of the table receive
            assert received[RC_TABLE:].any(), name
        if c["tpl"] is not None:
            seen["tpl"] += 1
            TP = c["table"].shape[0]
            bad = (c["tpl"] < 0) | (c["tpl"] >= TP)
            assert (bad & occ).any(), name
            assert TP == 3
    assert seen["B"] == {1, 3, 128, 130}
    assert {1, 40} <= seen["S"] and max(seen["S"]) > RC_TABLE
    assert seen["tpl"] >= 2


def test_l1_plans_only_occupied_rows():
    """lc_signal's plan, on every call of 40 lane-change steps of the 1x1s
    fixture: set on occupied rows only (the rows L2's kernel walks), and
    set somewhere."""
    from cityflow_tpu_torch import ring_sim
    from cityflow_tpu_torch.compiler.net import compile_scenario
    from cityflow_tpu_torch.core import ring_lc
    sim = ring_sim.build_sim(
        compile_scenario(os.path.join(FIX, "config_1x1s_lc.json")),
        horizon=48, device="cpu", sl=12, sk=6, skc=99)
    orig = ring_lc.lc_signal
    plans = []

    def rec(*a, **k):
        out = orig(*a, **k)
        n_l = a[2]
        occ = torch.arange(out[0].shape[0])[:, None, None] < n_l[None]
        plans.append((int(out[0].sum()), int((out[0] & ~occ).sum())))
        return out
    ring_lc.lc_signal = rec
    try:
        for _ in range(40):
            ring_sim.step(sim)
    finally:
        ring_lc.lc_signal = orig
    assert len(plans) == 40
    assert sum(n for n, _ in plans) > 0
    assert all(off == 0 for _, off in plans)
