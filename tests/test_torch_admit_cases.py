"""G12 admit_heads: the plain version against a numpy walk of the
reference's rule, on the seeded edge cases of
cityflow_tpu_torch/tools/kernel_cases.py (the cases chip_smoke.py holds the
CUDA kernel to on the card, bit for bit).

The walk restates Engine::handleWaiting (engine.cpp:502-516) and
Lane::available (roadnet.cpp:428-436) lane by lane: a lane's waiting
vehicles (active, not running, drv the lane) in FIFO order, the least uid
first and the least slot among equal uids; the head is the first; the lane
takes it when it has no rear vehicle from the previous step or that
vehicle's dis exceeds its len plus the head's minGap (strictly, in the
state's float type); the admitted vehicle runs with the list ticket
seq_counter and, behind a rear vehicle, follows it at gap
(dis - len) - its own dis, else scans for its leader. Where the least uid
repeats in a lane, every vehicle holding it is admitted with the head, as
the port's `is_head = waiting & (uid == least uid of the lane)` does (the
reference's uids do not repeat). The plain version computes the same with
two scatter-mins and a gathered lane pack.
"""

import numpy as np
import pytest

from cityflow_tpu_torch.kernels import admit_heads
from cityflow_tpu_torch.tools import kernel_cases as kc

P_LEN, P_MINGAP = 1, 7
I32_MAX = 2 ** 31 - 1


def _walk(c):
    """running, leader, gap, list_seq, need_scan, head and each lane's
    admitted slots ({(env, lane): [slots]}) by the reference's rule."""
    out = {k: c[k].copy() for k in ("running", "leader", "gap", "list_seq")}
    B, V = c["active"].shape
    L = c["L"]
    out["need_scan"] = np.zeros((B, V), bool)
    out["head"] = np.full((B, L), -1, np.int32)
    admitted = {}
    waiting = c["active"] & ~c["running"]
    for b in range(B):
        w = np.nonzero(waiting[b])[0]
        lane, uid = c["drv"][b, w], c["uid"][b, w]
        order = np.lexsort((w, uid, lane))        # lane, then FIFO order
        w, lane, uid = w[order], lane[order], uid[order]
        for l in np.unique(lane):
            mine = lane == l
            queue, quid = w[mine], uid[mine]
            head = queue[0]
            out["head"][b, l] = head
            tail = c["last_of"][b, l]
            if tail >= 0:
                tdis = c["dis"][b, tail]
                tlen = c["params"][b, tail, P_LEN]
                if not tdis > tlen + c["params"][b, head, P_MINGAP]:
                    continue
            heads = queue[quid == quid[0]]
            admitted[(b, int(l))] = list(heads)
            out["running"][b, heads] = True
            out["list_seq"][b, heads] = c["seq_counter"][b]
            out["need_scan"][b, heads] = tail < 0
            if tail >= 0:
                out["leader"][b, heads] = tail
                out["gap"][b, heads] = (tdis - tlen) - c["dis"][b, heads]
    return out, admitted


def _equal_bits(got, want):
    got = np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind == "f":
        return int((got.view(np.uint8) != want.view(np.uint8)).sum())
    return int((got != want).sum())


@pytest.mark.parametrize("name", kc.ADMIT_CASES)
def test_admit_plain_matches_reference_walk(name):
    case = kc.admit_case(name)
    got = admit_heads.admit_heads(*kc.admit_args(case, "cpu"))
    want, _ = _walk(case)
    for k, w in want.items():
        assert _equal_bits(got[k].numpy(), w) == 0, (name, k)


def test_admit_cases_reach_their_edges():
    """Each case holds the edges its generator names; the set covers both
    float types, B = 1, 3, 128 and 130, V not a multiple of four and
    misaligned views."""
    seen = {"B": set(), "fp": set(), "V4": set(), "offset": 0}
    for name, c in kc.admit_cases():
        B, V = c["active"].shape
        seen["B"].add(B)
        seen["fp"].add(c["dis"].dtype)
        seen["V4"].add(V % 4 == 0)
        seen["offset"] += c["offset"]
        waiting = c["active"] & ~c["running"]
        per_lane = lambda l: (waiting & (c["drv"] == l)).sum(1)
        assert (per_lane(0) > 1).all(), name       # many waiting
        assert (per_lane(1) == 1).all(), name      # one, at slot V - 1
        assert (per_lane(3) == 0).all(), name      # none
        want, admitted = _walk(c)
        assert (want["head"][:, 3] == -1).all(), name
        # lane 2's least uid at three waiting slots (its rear vehicle far
        # back), all admitted; lane 5's INT32_MAX at two, both admitted
        # where the lane is available
        for b in range(B):
            assert admitted[(b, 2)] == [2, 7, 9], (name, b)
            assert admitted.get((b, 5), [16, 17]) == [16, 17], (name, b)
        assert any((b, 5) in admitted for b in range(B)), name
        w_uid = c["uid"][waiting]
        assert (w_uid == I32_MAX).any() and (w_uid < 0).any(), name
        # lanes with a head and no rear vehicle (need_scan), and with one
        assert want["need_scan"].any(), name
        assert any(c["last_of"][b, l] >= 0 for b, l in admitted), name
        # lane 4's rear vehicle at exactly len + the head's minGap: not
        # available; one ulp above (odd envs): available
        assert (want["head"][:, 4] == 11).all(), name
        assert all((b, 4) in admitted for b in range(1, B, 2)), name
        assert not any((b, 4) in admitted for b in range(0, B, 2)), name
    assert seen["B"] == {1, 3, 128, 130}
    assert seen["fp"] == {np.dtype(np.float32), np.dtype(np.float64)}
    assert seen["V4"] == {True, False} and seen["offset"] >= 2
