"""L3 lc_insert: the plain version against a numpy walk of the reference's
rule, on the seeded edge cases of cityflow_tpu_torch/tools/kernel_cases.py
(the cases chip_smoke.py holds the CUDA kernel to on the card, bit for
bit).

The walk restates scheduleLaneChange / LaneChange::insertShadow
(engine.cpp:792-820, lanechange.cpp:71-102) with the JAX package's cap,
one target lane column at a time and with Python lists: the senders into
a lane are the do_change rows of its inner lane going +1, then of its
outer lane going -1, slots ascending; up to LCI of them win by distance,
highest first, the earlier of two equal ones first (a NaN or -inf
distance never wins; more candidates than LCI set overflow bit 1). Every
winner's real starts changing (chg, and dir = its direction unless it is
a shadow), as the TPU form does also for a winner that a full ring
refuses. Then each winner's shadow, a copy of its real with the target
lane's route rows, the shadow priority, the change direction and the
shadow constants, goes into the target's list of rows after every
occupied row with dis >= its dis; the list keeps S rows (the last falls
off); a full ring refuses it (overflow bit 2).

Also here: L3 writes in place; the preconditions its kernel takes from L1
and L2 hold on the lane-change fixtures' own calls; and the single-env
entries leave their input state as it was on a step that inserts shadows.
"""

import os

import numpy as np
import pytest
import torch

from cityflow_tpu_torch.kernels import lc_insert
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_follow_cases import _bits_equal

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SHBIT = 1 << 30
CONSTS = {"off": np.float32(0.0), "sh": True, "chg": False,
          "yv": np.float32(100.0), "custom": np.float32(0.0),
          "hascustom": False}


def _chans(case):
    """{name: (S, N, B) array} of every channel as lc_insert names them
    (rn{c} / ax{c} the route rows, yv L2's yield speed)."""
    ch = case["ch"]
    out = {}
    for name, _, _ in lc_insert.channel_spec(ch["rnrow"].shape[0],
                                             "tpl" in ch):
        if name == "yv":
            out[name] = case["yv"]
        elif name[:2] in ("rn", "ax") and name[2:].isdigit():
            out[name] = ch["rnrow" if name[:2] == "rn" else "auxrow"][
                int(name[2:])]
        else:
            out[name] = ch[name]
    return out


def _shadow(case, chans, t, q, b, d):
    """The shadow of row t of lane column q in env b, going d."""
    ch = case["ch"]
    M = ch["rnrow"].shape[0]
    lo = int(case["ln_llocal"][q]) + d
    ok = 0 <= lo < M
    row = {k: v[t, q, b] for k, v in chans.items()}
    row["nxt"] = np.int32(ch["rnrow"][lo, t, q, b] if ok else -1)
    aux = int(ch["auxrow"][lo, t, q, b]) if ok else -1
    row["nxt3"] = np.int32((aux >> 1) - 2 if aux >= 0 else -1)
    # int32 arithmetic: SHBIT + a uid near INT32_MAX wraps
    row["pri"] = np.int64(SHBIT + int(ch["uid"][t, q, b])).astype(np.int32)
    row["dir"] = np.int32(d)
    row.update(CONSTS)
    return row


def _walk(case):
    """(channels after the inserts, n_l, overflow bits, winners): winners
    as (env, target lane, source lane, slot, direction, inserted)."""
    chans = _chans(case)
    S, N, B = case["do_change"].shape
    LCI = case["LCI"]
    inner, outer = case["inner_src"], case["outer_src"]
    dc, dirc, dis = case["do_change"], case["dirc"], case["ch"]["dis"]
    ov = np.zeros((N, B), np.uint8)
    won = {}
    for b in range(B):
        for p in range(N):
            cands = []
            for q, d in ((inner[p], 1), (outer[p], -1)):
                if q >= 0:
                    cands += [(t, q, d) for t in range(S)
                              if dc[t, q, b] and dirc[t, q, b] == d]
            if len(cands) > LCI:
                ov[p, b] |= 1
            ok = [c for c in cands if dis[c[0], c[1], b] > -np.inf]
            ok.sort(key=lambda c: -dis[c[0], c[1], b])    # stable
            won[p, b] = ok[:LCI]
    # every winner's real starts changing
    chg2 = case["ch"]["chg"].copy()
    for (p, b), ws in won.items():
        for t, q, _ in ws:
            chg2[t, q, b] = True
    dir2 = np.where(case["ch"]["sh"], case["ch"]["dir"],
                    np.where(chg2, dirc, 0)).astype(np.int32)
    rings = dict(chans, chg=chg2, dir=dir2)
    out = {k: v.copy() for k, v in rings.items()}
    n_out = case["n_l"].copy()
    winners = []
    for (p, b), ws in won.items():
        rows = [{k: v[s, p, b] for k, v in rings.items()} for s in range(S)]
        n = int(case["n_l"][p, b])
        for t, q, d in ws:
            if n >= S:
                ov[p, b] |= 2
                winners.append((b, p, q, t, d, False))
                continue
            wd = dis[t, q, b]
            at = sum(bool(r["dis"] >= wd) for r in rows[:n])
            rows.insert(at, _shadow(case, chans, t, q, b, d))
            rows.pop()
            n += 1
            winners.append((b, p, q, t, d, True))
        for k in out:
            out[k][:, p, b] = [r[k] for r in rows]
        n_out[p, b] = n
    return out, n_out, ov, winners


@pytest.mark.parametrize("name", kc.INSERT_CASES)
def test_insert_plain_matches_reference_walk(name):
    case = kc.insert_case(name)
    a = kc.insert_args(case, "cpu")
    ch, yv, n_l = a[0], a[3], a[4]
    got, n_got, ov_got = lc_insert.lc_insert(*a)
    want, n_want, ov_want, _ = _walk(case)
    # in place: the returned tensors are the leaves, yv and n_l given
    assert n_got is n_l and got["yv"] is yv
    for k in ("dis", "chg", "dir", "tpl"):
        if k in ch:
            assert got[k] is ch[k], k
    assert got["rn0"].data_ptr() == ch["rnrow"][0].data_ptr()
    for k, v in want.items():
        assert _bits_equal(got[k].numpy(), v) == 0, (name, k)
    assert _bits_equal(n_got.numpy(), n_want) == 0, name
    assert _bits_equal(ov_got.numpy(), ov_want) == 0, name


def test_insert_cases_reach_their_edges():
    """Each case holds L1's and L2's guarantees, and the set reaches the
    edges kernel_cases.py names: LCI 1, 2, 3, 4 and 8, B = 1, 3, 128 and
    130, both overflow bits, winners from both sides, lanes without a
    neighbour, ties, a lane that sends and receives in one env, a target
    lane index outside [0, M), NaN candidates, templates."""
    seen = dict(LCI=set(), B=set(), tpl=0, ov1=0, ov2=0, side_in=0,
                side_out=0, tie_snd=0, tie_row=0, both=0, lo_out=0, nan=0,
                refused_start=0)
    for name, c in kc.insert_cases():
        ch = c["ch"]
        S, N, B = c["do_change"].shape
        seen["LCI"].add(c["LCI"])
        seen["B"].add(B)
        occ = np.arange(S)[:, None, None] < c["n_l"][None]
        assert not (c["do_change"] & ~occ).any(), name
        assert not ((ch["dir"] != 0) & ~ch["sh"] & ~ch["chg"]).any(), name
        assert not (ch["chg"] & ~ch["sh"] & (c["dirc"] != ch["dir"])).any()
        inner, outer = c["inner_src"], c["outer_src"]
        assert ((inner < 0) & (outer < 0)).any()
        # symmetric tables, as the compiler builds them
        for p in range(N):
            assert outer[p] < 0 or inner[outer[p]] == p
            assert inner[p] < 0 or outer[inner[p]] == p
        _, _, ov, winners = _walk(c)
        seen["ov1"] += int((ov & 1).any())
        seen["ov2"] += int((ov & 2).any())
        dis = ch["dis"]
        for b, p, q, t, d, ins in winners:
            seen["side_in" if d > 0 else "side_out"] += 1
            lo = c["ln_llocal"][q] + d
            seen["lo_out"] += ins and not 0 <= lo < ch["rnrow"].shape[0]
            wd = dis[t, q, b]
            seen["tie_row"] += ins and bool(
                (dis[:c["n_l"][p, b], p, b] == wd).any())
            seen["tie_snd"] += sum(
                1 for bb, pp, qq, tt, _, _ in winners
                if (bb, pp) == (b, p) and (qq, tt) != (q, t)
                and dis[tt, qq, b] == wd)
            seen["refused_start"] += not ins
            # the winner's lane also receives in this env
            seen["both"] += any(bb == b and pp == q and i2
                                for bb, pp, _, _, _, i2 in winners)
        cand = c["do_change"] & (c["dirc"] != 0)
        seen["nan"] += int((cand & np.isnan(dis)).any())
        seen["tpl"] += "tpl" in ch
    assert seen["LCI"] == {1, 2, 3, 4, 8}
    assert seen["B"] == {1, 3, 128, 130}
    for k in ("ov1", "ov2", "side_in", "side_out", "tie_snd", "tie_row",
              "both", "lo_out", "nan", "refused_start"):
        assert seen[k] > 0, k
    assert seen["tpl"] >= 3


def _lc_sim(config, horizon):
    from cityflow_tpu_torch import ring_sim
    from cityflow_tpu_torch.compiler.net import compile_scenario
    return ring_sim.build_sim(compile_scenario(os.path.join(FIX, config)),
                              horizon=horizon, device="cpu", sl=12, sk=6,
                              skc=99)


@pytest.mark.parametrize("config", ["config_1x1s_lc.json",
                                    "config_1x1s_mixed_lc.json"])
def test_l3_calls_meet_the_kernels_preconditions(config):
    """On every L3 call of 60 lane-change steps: do_change on occupied rows
    only, l_dir 0 on rows neither shadow nor changing (unoccupied rows
    included), dirc = l_dir on changing rows that are not shadows; and the
    call writes the state's leaves in place (n_l grows where shadows go
    in, the returned tensors are the state's)."""
    from cityflow_tpu_torch import ring_sim
    from cityflow_tpu_torch.core import ring_lc
    sim = _lc_sim(config, 68)
    orig = ring_lc.lc_insert
    seen = dict(calls=0, inserts=0, started=0)

    def rec(ch, do_change, dirc, yv, n_l, tabs, LCI):
        S = do_change.shape[0]
        occ = torch.arange(S)[:, None, None] < n_l[None]
        assert not (do_change & ~occ).any()
        assert not ((ch["dir"] != 0) & ~ch["sh"] & ~ch["chg"]).any()
        assert not (ch["chg"] & ~ch["sh"] & (dirc != ch["dir"])).any()
        n0, chg0 = n_l.clone(), ch["chg"].clone()
        out, n_new, ovl = orig(ch, do_change, dirc, yv, n_l, tabs, LCI)
        assert n_new is n_l and out["yv"] is yv and out["dis"] is ch["dis"]
        seen["calls"] += 1
        seen["inserts"] += int((n_l - n0).sum())
        seen["started"] += int((ch["chg"] & ~chg0).sum())
        return out, n_new, ovl
    ring_lc.lc_insert = rec
    try:
        for _ in range(60):
            ring_sim.step(sim)
    finally:
        ring_lc.lc_insert = orig
    assert seen["calls"] == 60
    assert seen["inserts"] > 0 and seen["started"] > 0, seen


def test_single_env_entries_leave_their_input_state_on_a_shadow_step():
    """test_torch_ring_regions.py's state check on a step whose L3 inserts
    shadows: ring_step_p1 / ring_step on one env leave the caller's state
    as it was, though the batched step writes the lane leaves in place."""
    from cityflow_tpu_torch.core import ring
    sim = _lc_sim("config_1x1s_lc.json", 120)
    st = sim.state
    for _ in range(100):
        snap = {k: v.clone() for k, v in st.leaves().items()}
        rs1, mid = ring.ring_step_p1(sim.tables, sim.cfg, st, sim.q)
        if int(rs1.l_sh.sum()) > int(st.l_sh.sum()):
            break
        st = ring.ring_step_p2(sim.tables, sim.cfg, rs1, mid)
    assert int(rs1.l_sh.sum()) > int(st.l_sh.sum()), "no shadow inserted"

    def unchanged(what):
        for k, v in st.leaves().items():
            assert torch.equal(v, snap[k]), f"{what} wrote {k}"
    unchanged("ring_step_p1")
    ring.ring_step(sim.tables, sim.cfg, st, sim.q)
    unchanged("ring_step")
    b = ring.batch_ring_state(st, 1)
    ring.ring_step_batched(sim.tables, sim.cfg, b, sim.q)
    unchanged("a step of batch_ring_state(st, 1)")
