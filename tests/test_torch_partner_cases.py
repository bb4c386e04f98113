"""L4 lc_partner: the plain version's two modes against a numpy walk of
partner_fetch's rule, on the seeded edge cases of
cityflow_tpu_torch/tools/kernel_cases.py (the cases chip_smoke.py holds
the CUDA kernel to on the card, bit for bit), and the lane-change ring
step's use of them: one match in p1, two gathers in p2.

The walk restates the rule row by row: a real looks toward l_dir, a
shadow toward -l_dir; the outer neighbour column where that is > 0, else
the inner one; the first of that column's slots below its n_l holding the
same uid (compared as int32) and the other shadow flag is the partner,
whose channels are read, on every row (occupied or not); `found` is a
partner on a paired row (occupied, a shadow or a changing real, with a
direction).
"""

import os

import numpy as np
import pytest
import torch

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.core import ring, ring_lc
from cityflow_tpu_torch.kernels import lc_partner
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_follow_cases import _bits_equal

HERE = os.path.dirname(os.path.abspath(__file__))
LEAVES = ("l_uid", "l_sh", "l_dir", "l_chg", "n_l")


def walk(c):
    """(values, found, match, events): the match as the kernel encodes it
    (slot, bit 14 on the outer side, -1 for none); events, the edges the
    rows met. Column by column: every row of a (lane, env) column against
    every slot of the neighbour column it looks at."""
    uid, sh, d, n_l, chg = (c[k] for k in ("uid", "sh", "l_dir", "n_l",
                                           "chg"))
    S, N, B = uid.shape
    inner, outer = c["inner_src"], c["outer_src"]
    vals = [np.zeros(uid.shape, np.float32) for _ in c["chans"]]
    found = np.zeros(uid.shape, bool)
    match = np.full(uid.shape, -1, np.int16)
    ev = set()
    slots = np.arange(S)
    for p in range(N):
        for b in range(B):
            u, f = uid[:, p, b], sh[:, p, b]
            look = np.where(f, -d[:, p, b], d[:, p, b])
            for out, q in ((False, inner[p]), (True, outer[p])):
                rows = (look > 0) == out
                if not rows.any():
                    continue
                if q < 0:
                    ev.add("no_outer" if out else "no_inner")
                    continue
                nq = min(max(int(n_l[q, b]), 0), S)
                uq, fq = uid[:, q, b], sh[:, q, b]
                same = u[:, None] == uq[None, :]          # (row, slot)
                cand = same & (f[:, None] != fq[None, :])
                live = slots[None, :] < nq
                hit = np.where((cand & live).any(1),
                               np.argmax(cand & live, 1), -1)
                first = np.where(hit >= 0, hit, S)[:, None]
                before = rows[:, None] & (slots[None, :] < first) & live
                if (before & same & ~cand).any():
                    ev.add("same_flag_skipped")
                f32 = (np.float32(u)[:, None] == np.float32(uq)[None, :])
                if (before & f32 & ~same).any():
                    ev.add("f32_equal_uid_skipped")
                if (rows & (hit < 0) & (cand & ~live).any(1)).any():
                    ev.add("stale_match_past_n_l")
                paired = ((slots < n_l[p, b]) & (f | chg[:, p, b])
                          & (look != 0))
                for s in np.nonzero(rows & (hit >= 0))[0]:
                    t = hit[s]
                    ev.add("hit_at_0" if t == 0 else "hit_later")
                    if t == nq - 1:
                        ev.add("hit_at_n_l_minus_1")
                    ev.add("found" if paired[s] else "hit_unpaired")
                    if look[s] == 0:
                        ev.add("hit_dir_0")
                    if u[s] > 2 ** 30:
                        ev.add("big_uid_hit")
                    for v, ch in zip(vals, c["chans"]):
                        v[s, p, b] = ch[t, q, b]
                    found[s, p, b] = paired[s]
                    match[s, p, b] = t | (out << 14)
    return vals, found, match, ev


@pytest.mark.parametrize("name", kc.PARTNER_CASES)
def test_partner_plain_matches_reference_walk(name):
    """The match mode's values, found and match, and the gather mode's
    values at that match (of the same channels, and of fresh ones),
    bitwise against the walk."""
    case = kc.partner_case(name)
    a = kc.partner_args(case, "cpu")
    vals, found, match = lc_partner.lc_partner(*a)
    want_v, want_f, want_m, _ = walk(case)
    assert _bits_equal(found.numpy(), want_f) == 0, name
    assert _bits_equal(match.numpy(), want_m) == 0, name
    for g, w in zip(vals, want_v):
        assert _bits_equal(g.numpy(), w) == 0, name
    for g, w in zip(lc_partner.lc_partner_gather(match, a[5], a[6]), want_v):
        assert _bits_equal(g.numpy(), w) == 0, name
    rng = np.random.default_rng(5)
    fresh = [rng.uniform(-9, 9, c.shape).astype(np.float32)
             for c in case["chans"]]
    got = lc_partner.lc_partner_gather(
        match, [torch.as_tensor(f) for f in fresh], a[6])
    want_v, _, _, _ = walk(dict(case, chans=fresh))
    for g, w in zip(got, want_v):
        assert _bits_equal(g.numpy(), w) == 0, name


def test_partner_cases_reach_their_edges():
    """The cases cover B = 1, 3, 128 and 130, S = 1 to 800, C = 1
    to 4, and every edge of the rule; env 0's crafted lane finds what it
    was made for."""
    seen = {"B": set(), "S": set(), "C": set()}
    union = set()
    for name, c in kc.partner_cases():
        S, N, B = c["uid"].shape
        seen["B"].add(B)
        seen["S"].add(S)
        seen["C"].add(len(c["chans"]))
        vals, found, match, ev = walk(c)
        union |= ev
        if S >= 6 and N >= 3:
            m, f = match[:5, 1, 0], found[:5, 1, 0]
            outer = 1 << 14
            assert list(m) == [0 | outer, 3, 1, -1, 2 | outer], (name, m)
            assert list(f) == [True, True, False, False, True], (name, f)
    assert seen["B"] >= {1, 3, 128, 130}
    assert min(seen["S"]) == 1 and max(seen["S"]) >= 800
    assert seen["C"] == {1, 2, 3, 4}
    want = {"no_inner", "no_outer", "hit_at_0", "hit_later",
            "hit_at_n_l_minus_1", "same_flag_skipped", "stale_match_past_n_l",
            "found", "hit_unpaired", "hit_dir_0", "big_uid_hit",
            "f32_equal_uid_skipped"}
    assert want <= union, want - union


def test_lc_partner_refuses_past_its_fields():
    """The match keeps the slot in 14 bits and the kernel's offsets are
    32-bit: S above 16384 or S * N * B past 2^31 is refused, on the CPU
    too; the largest lane-change path fits."""
    with pytest.raises(ValueError, match="14-bit"):
        lc_partner.fits(16385, 4, 1)
    with pytest.raises(ValueError, match="32-bit"):
        lc_partner.fits(40, 11160, 5000)
    lc_partner.fits(40, 11160, 128)


def _stack(states):
    """Single-env RingStates -> one batched state, env i = states[i]."""
    return ring.RingState(**{k: torch.stack([getattr(s, k) for s in states],
                                            -1)
                             for k in states[0].leaves()})


@pytest.fixture(scope="module")
def lc_batch():
    """The ring on config_1x1s_lc.json at B = 3: envs from steps 5, 6 and
    7 of one env (a shadow on the rings in each; it finishes in step 8)."""
    net = compile_scenario(os.path.join(HERE, "fixtures",
                                        "config_1x1s_lc.json"))
    sim = ring_sim.build_sim(net, horizon=64, device="cpu", sl=12, sk=6,
                             skc=99)
    states = []
    for i in range(1, 8):
        ring_sim.step(sim)
        if i >= 5:
            states.append(sim.state)
    assert all(bool(s.l_sh.any()) for s in states)
    return sim, _stack(states)


def _lc_pairs_three_searches(net, cfg, rs, ex, mid):
    """_lc_pairs as it stood with an L4 search in each pair round."""
    leave = ex["leave"]
    (pA, pB), pf2 = ring_lc.partner_fetch(net, rs, [ex["chanA"],
                                                    ex["chanB"]])
    p1 = ring.ring_exits_pairs(cfg, net, rs, mid["new_spd_l"], leave, pA,
                               pf2)
    (pAb, pFin), pf3 = ring_lc.partner_fetch(
        net, rs, [p1["abort_sh"], p1["finish_pre"]])
    assert torch.equal(pf3, pf2)      # one found mask for both stages
    p2 = ring.ring_exits_finish(cfg, net, rs, leave, p1["abort_sh"],
                                p1["finish_pre"], pAb, pFin, pf2, pB,
                                ex["n_rm"], ex["t_rm"])
    return dict(p2, leave_full=leave, new_off=p1["new_off"])


def test_match_once_equals_three_searches(lc_batch, monkeypatch):
    """A B = 3 lane-change step whose p2 gathers at p1's match equals the
    same step with a search in each of its three L4 calls, on every leaf,
    bitwise; p2 requires the match."""
    sim, st = lc_batch
    fresh = lambda: st.map(torch.clone)
    s1, mid = ring.ring_step_p1_batched(sim.tables, sim.cfg, fresh(), sim.q)
    bare = {k: v for k, v in mid.items() if k not in ring.LC_MATCH_KEYS}
    with pytest.raises(KeyError):
        ring.ring_step_p2_batched(sim.tables, sim.cfg, s1, bare)
    s1, mid = ring.ring_step_p1_batched(sim.tables, sim.cfg, fresh(), sim.q)
    assert set(ring.LC_MATCH_KEYS) <= set(mid)
    got = ring.ring_step_p2_batched(sim.tables, sim.cfg, s1, mid)
    monkeypatch.setattr(ring, "_lc_pairs", _lc_pairs_three_searches)
    s1, mid = ring.ring_step_p1_batched(sim.tables, sim.cfg, fresh(), sim.q)
    want = ring.ring_step_p2_batched(sim.tables, sim.cfg, s1, mid)
    for k, w in want.leaves().items():
        assert _bits_equal(getattr(got, k).numpy(), w.numpy()) == 0, k


def test_partner_leaves_unchanged_between_the_calls(lc_batch, monkeypatch):
    """The gathers of p2 see the uid, sh, dir, chg and n_l that p1's match
    was made on: nothing between them (the rest of p1, R2's exits and its
    pair stage) writes them. One match and two gathers a step."""
    sim, st = lc_batch
    seen = []
    match_fn, gather_fn = ring_lc.partner_fetch, ring_lc.partner_gather

    def fetch(net, rs, chans, **kw):
        seen.append(("match", {k: getattr(rs, k).clone() for k in LEAVES}))
        return match_fn(net, rs, chans, **kw)

    snap = {}

    def gather(net, match, chans):
        seen.append(("gather", {k: v.clone() for k, v in snap.items()}))
        return gather_fn(net, match, chans)

    orig_pairs = ring._lc_pairs

    def pairs(net, cfg, rs, ex, mid):
        snap.update({k: getattr(rs, k) for k in LEAVES})
        return orig_pairs(net, cfg, rs, ex, mid)

    monkeypatch.setattr(ring_lc, "partner_fetch", fetch)
    monkeypatch.setattr(ring_lc, "partner_gather", gather)
    monkeypatch.setattr(ring, "_lc_pairs", pairs)
    s1, mid = ring.ring_step_p1_batched(sim.tables, sim.cfg,
                                        st.map(torch.clone), sim.q)
    ring.ring_step_p2_batched(sim.tables, sim.cfg, s1, mid)
    assert [k for k, _ in seen] == ["match", "gather", "gather"]
    for _, leaves in seen[1:]:
        for k in LEAVES:
            assert torch.equal(leaves[k], seen[0][1][k]), k
