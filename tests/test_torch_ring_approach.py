"""The approach rows' to_link pack (R7's approach mode,
kernels/ring_pack.pack_approach) and K2 reading the foe exchange in place
(kernels/cross_caps.py, `fields` through `foe_src`) of the PyTorch port,
on the CPU (their plain versions), against the JAX package.

The pack is held through the step's p1 (`mid`: the approach rows' fails,
first-fail foes and red stops equal, their speeds and distances within
1e-5, as test_torch_ring.py's per-phase tests) on states seeded with a
front retargeted to another out-link of its lane (so the link it left
reads the fill), a lane front slot emptied and an emptied lane. An
in-lane without a lane (in_src < 0) is held to the fill on an edited
table, and through p1 against JAX's p1 on the same edit. Crosses without
a foe (foe_src -1; a zero row of JAX's foe_perm) are held through p1
against JAX's; K2's in-place read is also held, bit for bit, against a
walk over each link's crosses that skips a cross without a foe (the
kernel's loop), uniform and with templates. Batched calls equal each env
alone, bit for bit (B = 3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cityflow_tpu.core import ring as jax_ring

from cityflow_tpu_torch.carry import ring_state_from_numpy
from cityflow_tpu_torch.core import ring
from cityflow_tpu_torch.core.step import can_yield, reach_steps
from cityflow_tpu_torch.kernels import cross_caps as k2
from cityflow_tpu_torch.kernels.ring_pack import (
    pack_approach, pack_approach_plain)
from test_torch_ring import assert_close, jax_leaves
from test_torch_ring_packs import _Scenario, _jstate

torch.set_num_threads(2)

_SCEN = {}


@pytest.fixture(scope="module")
def scen():
    def get(name):
        if name not in _SCEN:
            _SCEN[name] = _Scenario(name)
        return _SCEN[name]
    yield get
    _SCEN.clear()


def _copy(leaves):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in leaves.items()}


def _retarget_front(sc, st):
    """A lane front with two or more out-links that exist heads into
    another of them (its l_nxt: LNp + the link). Returns (lane, the link
    it left, the link it now heads into)."""
    cfg = sc.tsim.cfg
    IL, KOUT, G = cfg.IL, cfg.KOUT, cfg.G
    out_src = sc.tb["out_src"].reshape(IL, KOUT, G)
    in_src = sc.tb["in_src"].reshape(IL, G)
    for il in range(IL):
        for g in range(G):
            lane = int(in_src[il, g])
            if lane < 0 or st["n_l"][lane] < 1:
                continue
            old = int(st["l_nxt"][0, lane]) - cfg.LNp
            lks = [int(out_src[il, k, g]) for k in range(KOUT)
                   if out_src[il, k, g] >= 0]
            other = [lk for lk in lks if lk != old]
            if old in lks and other:
                st["l_nxt"][0, lane] = cfg.LNp + other[0]
                return lane, old, other[0]
    raise AssertionError("no lane front with two out-links")


def _empty_slots(sc, st):
    """An in-lane's lane holding two or more vehicles cut to its front
    (slot 1 of the approach rows empty), and another one emptied."""
    in_src = sc.tb["in_src"].reshape(-1)
    busy = [ln for ln in np.nonzero(st["n_l"] > 1)[0] if ln in in_src]
    assert len(busy) >= 2
    st["n_l"][busy[0]] = 1
    st["n_l"][busy[-1]] = 0
    return int(busy[0]), int(busy[-1])


def _p1_inputs(sc, st, B=1):
    """The forward view and the start / end-lane bundles p1 gives the
    approach pack, on the port's state `st` (numpy leaves) at B envs."""
    cfg, tb = sc.tsim.cfg, sc.tsim.tables
    rs = ring.batch_ring_state(ring_state_from_numpy(st, "cpu"), B)
    inl = ring.pack_forward(cfg, tb, rs)
    rng = np.random.default_rng(2)
    shape = (7 if cfg.uniform else 8, cfg.LKp, B)
    bundle = torch.as_tensor(rng.uniform(0.0, 80.0, shape).astype(np.float32))
    et = None
    if not cfg.uniform:
        et = bundle.clone()
        et[5] = torch.as_tensor(rng.random(shape[1:]) < 0.6).float()
        et[6] = torch.as_tensor(rng.integers(-1, cfg.TP + 1, shape[1:])
                                .astype(np.float32))
        et[2] = torch.as_tensor(rng.integers(0, 4, shape[1:])
                                .astype(np.float32))
    return rs, inl, bundle, et


def _p1_both(sc, st, jtabs, ttabs, spread_g=None):
    """p1 of JAX and of the port from the numpy state `st` on their
    (edited) tables: the state and every `mid` entry compared, the
    approach rows' fails, first-fail foes and red stops equal. Returns the
    port's mid.

    `spread_g`: the intersection of an in-lane cut from its lane. Its
    links' start length is then 0, and a stopped row there has the
    stop-before speed 0 - 0 / 0 = NaN (test_torch_templates.py's
    test_stopped_at_the_lane_end_keeps_the_reference_min). JAX's one-hot
    einsum back to the in-lanes (from_link) multiplies that NaN by 0 into
    every in-lane of the intersection; the port reads only each front's
    own link. Where JAX's speeds and distances are NaN, the port's must be
    finite and on that intersection's in-lanes (lanes); elsewhere they are
    compared as everywhere."""
    rs1, mid = jax_ring.ring_step_p1(jtabs, sc.jsim.cfg, _jstate(st),
                                     sc.jsim.q)
    trs1, tmid = ring.ring_step_p1(ttabs, sc.tsim.cfg,
                                   ring_state_from_numpy(st, "cpu"),
                                   sc.tsim.q)
    for k, v in jax_leaves(rs1).items():
        assert_close(f"p1 {k}", v, getattr(trs1, k).numpy())
    # the port's mid also keeps L4's match for p2 (JAX's p2 searches
    # again)
    assert set(mid) == set(tmid) - set(ring.LC_MATCH_KEYS)
    for k in ("ap_fail", "ap_ffo", "ap_red"):
        np.testing.assert_array_equal(tmid[k].numpy(), np.asarray(mid[k]),
                                      err_msg=k)
    G = sc.tsim.cfg.G
    lane_g = np.where(sc.tb["in_inv"] >= 0, sc.tb["in_inv"] % G, -1)
    for k, v in mid.items():
        want, got = np.asarray(v), tmid[k].numpy()
        if spread_g is not None and want.dtype.kind == "f":
            nan = np.isnan(want)
            assert np.isfinite(got[nan]).all(), k
            where = np.nonzero(nan)[-1]
            g = where if k.startswith("ap_") else lane_g[where]
            assert (g == spread_g).all(), k
            want, got = np.where(nan, 0.0, want), np.where(nan, 0.0, got)
        assert_close(f"mid {k}", want, got)
    return tmid


@pytest.mark.parametrize("name", ["4x4", "mixed", "lc", "mixed_lc"])
def test_p1_through_the_approach_pack_matches_jax(scen, name):
    """p1 from a state with a retargeted lane front, an emptied front slot
    and an emptied lane: every `mid` entry against JAX's; the approach
    rows' fails, first-fail foes and red stops equal, their speeds and
    distances within 1e-5. The pack itself reads the fill on the link the
    front left and on the emptied slots."""
    sc = scen(name)
    cfg = sc.tsim.cfg
    st = _copy(sc.leaves)
    lane, left, into = _retarget_front(sc, st)
    cut, emptied = _empty_slots(sc, st)
    _p1_both(sc, st, sc.jsim.tables, sc.tsim.tables)
    # the pack on that state: the retargeted front reaches only the link
    # it now heads into; the cut and emptied lanes' empty slots nowhere
    rs, inl, st_b, et = _p1_inputs(sc, st)
    ap = pack_approach(cfg, sc.tsim.tables, inl, st_b, et)
    start = sc.tb["start_src"]
    in_src = sc.tb["in_src"].reshape(-1)
    j = int(np.nonzero(in_src == lane)[0][0])
    assert start[into] == j and start[left] == j
    assert bool(ap["mine"][0, into, 0]) and not bool(ap["mine"][0, left, 0])
    assert float(ap["speed"][0, left, 0]) == 0.0
    for ln, slots in ((cut, range(1, cfg.AP)), (emptied, range(cfg.AP))):
        rows = np.nonzero(start == int(np.nonzero(in_src == ln)[0][0]))[0]
        for s in slots:
            assert not bool(ap["mine"][s, rows].any()), (ln, s)


@pytest.mark.parametrize("name", ["4x4", "mixed"])
def test_an_in_lane_without_a_lane_reads_the_fill_in_the_approach_pack(
        scen, name):
    """One in-lane's lane taken out of the tables (in_src -1): every link
    it starts reads +0.0 in every channel (dls = -st_len, lane_left =
    st_len; with templates template 0's approach distance and canEnter),
    every other link as with the full tables; and p1 on that edit matches
    JAX's p1 on the same edit of its tables."""
    sc = scen(name)
    cfg = sc.tsim.cfg
    B = 2
    rs, inl_f, st_b, et = _p1_inputs(sc, sc.leaves, B)
    in_src = sc.tb["in_src"].reshape(-1)
    j = int(np.nonzero(sc.leaves["n_l"][in_src] > 0)[0][0])
    cut_src = in_src.copy()
    cut_src[j] = -1
    cut = dict(sc.tsim.tables, in_src=torch.as_tensor(cut_src.reshape(
        sc.tb["in_src"].shape)))
    inl_c = ring.pack_forward(cfg, cut, rs)
    full = pack_approach(cfg, sc.tsim.tables, inl_f, st_b, et)
    got = pack_approach(cfg, cut, inl_c, st_b, et)
    starts = torch.as_tensor(sc.tb["start_src"] == j)
    assert bool(starts.any())
    assert bool(full["mine"][:, starts].any())
    assert not bool(got["mine"][:, starts].any())
    for k in ("speed", "prih", "pril"):
        v = got[k][:, starts]
        assert torch.equal(v, torch.zeros_like(v)), k
        assert not bool(torch.signbit(v).any()), k
    stl = st_b[6][starts]
    assert torch.equal(got["dls"][:, starts], (0.0 - stl).expand(
        cfg.AP, *stl.shape))
    assert torch.equal(got["lane_left"][:, starts],
                       (stl - 0.0).expand(cfg.AP, *stl.shape))
    if not cfg.uniform:
        assert torch.equal(got["tpl"][:, starts],
                           torch.zeros_like(got["tpl"][:, starts]))
    for k in full:
        assert torch.equal(got[k][:, ~starts], full[k][:, ~starts]), k
    jcut = dict(sc.jsim.tables, in_src=jnp.asarray(cut_src.reshape(
        np.shape(sc.jsim.tables["in_src"]))))
    tmid = _p1_both(sc, sc.leaves, jcut, cut, spread_g=j % cfg.G)
    _, tfull = ring.ring_step_p1(sc.tsim.tables, cfg, ring_state_from_numpy(
        sc.leaves, "cpu"), sc.tsim.q)
    assert not torch.equal(tmid["inl"], tfull["inl"])


@pytest.mark.parametrize("name", ["4x4", "mixed"])
def test_p1_with_crosses_without_a_foe_matches_jax(scen, name):
    """Half the crosses that have a foe lose it: a zero row of JAX's
    foe_perm (its one-hot sum reads +0.0 there) and foe_src -1 over that
    type's columns in the port (K2 skips the cross). p1 on the link and
    approach rows matches JAX's on the same edit, and the edit changes
    some approach row's decision (no link row fails in these states)."""
    sc = scen(name)
    cfg, jcfg = sc.tsim.cfg, sc.jsim.cfg
    assert "foe_perm" in sc.jsim.tables
    perm = np.asarray(sc.jsim.tables["foe_perm"]).copy()   # (T, S2, S2)
    has = perm.any(-1)
    drop = has & (np.random.default_rng(23).random(has.shape) < 0.5)
    assert drop.any()
    perm[drop] = 0.0
    src = sc.tb["foe_src"].copy().reshape(-1, cfg.G)       # (S2, G)
    for t, (g0, g1) in enumerate(jcfg.type_ranges):
        src[np.nonzero(drop[t])[0], g0:g1] = -1
    jt = dict(sc.jsim.tables, foe_perm=jnp.asarray(perm))
    tt = dict(sc.tsim.tables, foe_src=torch.as_tensor(src.reshape(-1)))
    tmid = _p1_both(sc, sc.leaves, jt, tt)
    _, tfull = ring.ring_step_p1(sc.tsim.tables, cfg, ring_state_from_numpy(
        sc.leaves, "cpu"), sc.tsim.q)
    assert not torch.equal(tmid["ap_fail"], tfull["ap_fail"])


def _k2_inputs(sc, rng, R, B, tpl):
    cfg, tb = sc.tsim.cfg, sc.tsim.tables
    KC, LK = cfg.KC, cfg.LKp
    f32 = lambda lo, hi, *s: torch.as_tensor(rng.uniform(lo, hi, s)
                                             .astype(np.float32))
    ints = lambda lo, hi, *s: torch.as_tensor(rng.integers(lo, hi, s)
                                              .astype(np.float32))
    rows = (f32(-20.0, 60.0, R, LK, B), f32(0.0, 17.0, R, LK, B),
            ints(0, 30, R, LK, B), ints(-2, 2, R, LK, B),
            ints(0, 3, R, LK, B),
            torch.as_tensor(rng.random((R, LK, B)) < 0.8))
    NF = KC * LK
    fields = torch.stack(
        [torch.as_tensor((rng.random((NF, B)) < 0.7).astype(np.float32))
         for _ in range(4)]
        + [ints(0, 40, NF, B), f32(-10.0, 60.0, NF, B), ints(0, 30, NF, B),
           ints(-2, 2, NF, B), ints(0, 3, NF, B)])
    foe_src = tb["foe_src"].clone()
    drop = torch.as_tensor(rng.random(foe_src.shape) < 0.2)
    foe_src[drop] = -1
    assert bool((foe_src < 0).any()) and bool((foe_src >= 0).any())
    # cross rows whose foe is gone yet valid, in front: the walk skips them
    valid = tb["lk_cvalid"].reshape(-1)
    assert bool((valid & (foe_src < 0)).any())
    kw = {}
    if tpl:
        kw = dict(tpl=torch.as_tensor(rng.integers(-1, cfg.TP + 1, (R, LK, B))
                                      .astype(np.int32)),
                  table=tb["tpl_params"])
    cx = ring._Ctx(tb, cfg, "cpu")
    return rows, fields, foe_src, cx, kw


def _walk(rows, fields, foe_src, tabs, prm, tpl=None, table=None):
    """K2's loop written out: each row walks its link's crosses in order,
    skips a cross that is not considered or has no foe (foe_src -1), and
    keeps the nearest failing cross (ties: the largest foe lpi)."""
    dls, speed, ent, ph, plo, rel = rows
    R, LK, B = dls.shape
    KC = tabs["d"].shape[0]
    t = lambda v: torch.tensor(float(v), dtype=torch.float32)
    maxneg, yld, ln, turnspd, maxspd, upa, dt = (t(v) for v in prm)
    if tpl is not None:
        p = k2.tpl_params_plain(tpl, table, k2.TPL_COLS)
        maxneg, yld, ln, turnspd, maxspd, upa = p
    target = torch.where(tabs["turn"][None, :, None], turnspd, maxspd)
    any_fail = torch.zeros((R, LK, B), dtype=torch.bool)
    ff_d = torch.full((R, LK, B), torch.inf)
    ff_foe = torch.full((R, LK, B), -1, dtype=torch.int32)
    for kc in range(KC):
        d = tabs["d"][kc][None, :, None]
        src = foe_src.reshape(KC, LK)[kc]
        has = (src >= 0)[None, :, None]
        foe = fields[:, src.clamp(min=0).long()][:, None]   # (9, 1, LK, B)
        d1 = d - dls
        self_yield = can_yield(speed, maxneg, yld, ln, d1)
        sr = torch.clamp_max(reach_steps(speed, d1, target, upa, dt), 255)
        fr, fdist, fent, fph, fplo = foe[4:9]
        pri_win = (ph > fph) | ((ph == fph) & (plo > fplo))
        srank = torch.where(fr > sr, -1, torch.where(fr < sr, 1, torch.where(
            ent == fent, torch.where(d1 == fdist, torch.where(pri_win, -1, 1),
                                     torch.where(d1 < fdist, -1, 1)),
            torch.where(ent < fent, -1, 1))))
        dpos = fdist > 0
        t_eq = torch.where(dpos, srank, torch.where(foe[2] > 0.5, -1, 1))
        t_lt = torch.where(dpos, torch.where(fr > sr, -1, 1),
                           torch.where(foe[2] > 0.5, -1, 1))
        t1 = tabs["t1"][None, :, None]
        t2 = tabs["t2"][kc][None, :, None]
        y = torch.where(t1 > t2, -1, torch.where(t1 < t2, t_lt, t_eq))
        y = torch.where(foe[1] > 0.5, y, 1)
        y = torch.where((y == 1) & (foe[3] > 0.5), -1, y)
        passes = (foe[0] <= 0.5) | ~self_yield | (y == -1)
        cons = tabs["cvalid"][kc][None, :, None] & (d >= dls) & rel
        fail = cons & has & ~passes
        fl = tabs["foelpi"][kc][None, :, None].expand(R, LK, B)
        nearer = fail & (d < ff_d)
        tie = fail & (d == ff_d) & (fl > ff_foe)
        ff_foe = torch.where(nearer | tie, fl, ff_foe)
        ff_d = torch.where(nearer, d.expand(R, LK, B), ff_d)
        any_fail = any_fail | fail
    return any_fail, ff_d, ff_foe


@pytest.mark.parametrize("name,tpl", [("4x4", False), ("mixed", True)])
def test_cross_caps_reads_the_foe_in_place_as_the_kernel_walks(scen, name,
                                                                tpl):
    """K2 on R1's fields through foe_src (a fifth of its entries set to
    -1, valid crosses among them) equals, bit for bit, the kernel's walk
    over the crosses that skips a cross without a foe; and equals K2 on
    the gathered slab's rows of a table without -1 (the missing foe as a
    row of +0.0)."""
    sc = scen(name)
    rng = np.random.default_rng(17)
    B = 3
    rows, fields, foe_src, cx, kw = _k2_inputs(sc, rng, 2, B, tpl)
    got = k2.cross_caps(*rows, fields, foe_src, cx.cc_tabs, cx.prm_cc, **kw)
    want = _walk(rows, fields, foe_src, cx.cc_tabs, cx.prm_cc, **kw)
    for g, w, n in zip(got, want, ("any_fail", "ff_d", "ff_foe")):
        assert g.dtype == w.dtype, n
        assert torch.equal(g, w), (n, int((g != w).sum()))
    assert bool(got[0].any()) and not bool(got[0].all())
    zero = torch.cat([fields, torch.zeros((9, 1, B))], 1)
    src0 = torch.where(foe_src < 0, fields.shape[1], foe_src).to(torch.int32)
    again = k2.cross_caps(*rows, zero, src0, cx.cc_tabs, cx.prm_cc, **kw)
    for g, w in zip(got, again):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["lc", "mixed"])
def test_batched_approach_pack_and_cross_caps_equal_each_env_alone(scen,
                                                                   name):
    """Three envs from different states (one retargeted front, one with an
    emptied slot and lane) in one call of the approach pack and of K2's
    in-place read equal each env alone, bit for bit; and the batched p1
    equals each env's p1."""
    sc = scen(name)
    cfg, tb = sc.tsim.cfg, sc.tsim.tables
    states = [_copy(sc.leaves) for _ in range(3)]
    _retarget_front(sc, states[1])
    _empty_slots(sc, states[2])
    singles = [ring_state_from_numpy(s, "cpu") for s in states]
    b = ring.RingState(**{k: torch.stack([getattr(s, k) for s in singles],
                                         -1).contiguous()
                          for k in singles[0].leaves()})
    inl_b = ring.pack_forward(cfg, tb, b)
    rng = np.random.default_rng(4)
    st_b = torch.as_tensor(rng.uniform(0.0, 80.0, (8, cfg.LKp, 3))
                           .astype(np.float32))
    et_b = None if cfg.uniform else st_b.flip(0).contiguous()
    ap_b = pack_approach_plain(cfg, tb, inl_b, st_b, et_b)
    rows, fields, foe_src, cx, kw = _k2_inputs(sc, rng, 2, 3, not cfg.uniform)
    k2_b = k2.cross_caps(*rows, fields, foe_src, cx.cc_tabs, cx.prm_cc, **kw)
    e_ = lambda x, e: x[..., e:e + 1].contiguous()
    for e in range(3):
        one = ring.batch_ring_state(singles[e], 1)
        ap1 = pack_approach_plain(
            cfg, tb, ring.pack_forward(cfg, tb, one), e_(st_b, e),
            None if et_b is None else e_(et_b, e))
        assert set(ap1) == set(ap_b)
        for k, v in ap1.items():
            assert torch.equal(e_(ap_b[k], e), v), (e, k)
        k1 = k2.cross_caps(*(e_(r, e) for r in rows), e_(fields, e), foe_src,
                           cx.cc_tabs, cx.prm_cc,
                           **{k: (e_(v, e) if k == "tpl" else v)
                              for k, v in kw.items()})
        for g, w in zip(k1, k2_b):
            assert torch.equal(g, e_(w, e)), e
    _, mid_b = ring.ring_step_p1_batched(tb, cfg, b, sc.tsim.q)
    for e, s in enumerate(singles):
        _, mid1 = ring.ring_step_p1(tb, cfg, s, sc.tsim.q)
        for k, v in mid1.items():
            assert torch.equal(mid_b[k][..., e], v), (e, k)
