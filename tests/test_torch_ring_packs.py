"""The ring step's front leaders (R5, kernels/front_leaders.py), gap refresh
(R6, kernels/gap_refresh.py), channel packs (R7, kernels/ring_pack.py) and
K3's ring-leader mode (kernels/car_follow.py) of the PyTorch port, on the
CPU (their plain versions), against the JAX package.

R5's lane-change mode and R6 are held against the JAX package's own
module-level lc_front_ctx and refresh_gaps, on lane-change states whose
out-link ring tails are seeded into exact ties, some of those rings
emptied. R5's approach mode, R7's three modes and K3's ring-leader mode
are held through the step's p1 and p2 outputs (`mid`, the committed
state) on states that hold a full lane ring (n = SL), emptied rings,
tied out-link tails and out-links marked invalid. Ints and bools equal,
float32 within 1e-5, as test_torch_ring.py's per-phase tests. The test
fixtures map every in-lane to a lane; an in-lane without one (in_src < 0,
a padding column) is held to the gathers' fill on an edited table. The states come from the port's own CPU run (JAX's step runs op by
op here, a few seconds a phase), one per scenario, cached.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cityflow_tpu import ring_sim as jax_ring_sim
from cityflow_tpu.compiler.net import compile_scenario as jax_compile
from cityflow_tpu.core import ring as jax_ring
from cityflow_tpu.core import ring_lc as jax_lc

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.carry import ring_state_from_numpy
from cityflow_tpu_torch.compiler.net import P_LEN, P_MINGAP, compile_scenario
from cityflow_tpu_torch.core import ring, ring_lc
from test_torch_ring import assert_close, jax_leaves, p2_mid

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
SCEN = {
    "4x4": ("config_4x4.json", {}, 30),
    "lc": ("config_1x1s_lc.json", dict(sl=12, sk=6, skc=99), 60),
    "mixed": ("config_2x2_mixed.json", dict(skc=99), 45),
    "mixed_lc": ("config_1x1s_mixed_lc.json", dict(sl=12, sk=6, skc=99), 60),
}


def _jstate(leaves):
    return jax_ring.RingState(**{
        f.name: None if leaves.get(f.name) is None
        else jnp.asarray(leaves[f.name])
        for f in dataclasses.fields(jax_ring.RingState)})


class _Scenario:
    """Both sims of one fixture and the port's state after `at` steps."""

    def __init__(self, name):
        cfg_file, kw, at = SCEN[name]
        path = os.path.join(FIX, cfg_file)
        self.jsim = jax_ring_sim.build_sim(jax_compile(path),
                                           horizon=at + 8, **kw)
        self.tsim = ring_sim.build_sim(compile_scenario(path),
                                       horizon=at + 8, device="cpu", **kw)
        st = self.tsim.state
        for _ in range(at):
            st = ring.ring_step(self.tsim.tables, self.tsim.cfg, st,
                                self.tsim.q)
        self.leaves = {k: v.numpy().copy() for k, v in st.leaves().items()}
        self.tb = {k: v.numpy() for k, v in self.tsim.tables.items()}


_SCEN = {}


@pytest.fixture(scope="module")
def scen():
    def get(name):
        if name not in _SCEN:
            _SCEN[name] = _Scenario(name)
        return _SCEN[name]
    yield get
    _SCEN.clear()


def _len_of(sc, tpl):
    cfg = sc.tsim.cfg
    if cfg.uniform:
        return np.float32(cfg.params[P_LEN])
    return np.float32(sc.tb["tpl_params"][tpl, P_LEN])


def _invalidate(sc, rng):
    """(JAX's, the port's) tables and the numpy out_valid_g with one in
    four of the out-links that exist marked invalid."""
    valid = sc.tb["out_valid_g"].copy()
    cfg = sc.tsim.cfg
    exists = sc.tb["out_src"].reshape(valid.shape[:3]) >= 0
    drop = exists & (rng.random(valid.shape[:3]) < 0.25)
    valid[drop] = 0.0
    return (dict(sc.jsim.tables, out_valid_g=jnp.asarray(
                valid.reshape(np.shape(sc.jsim.tables["out_valid_g"])))),
            dict(sc.tsim.tables, out_valid_g=torch.as_tensor(valid)),
            valid) if cfg.KOUT else None


def _tie_tails(sc, st, rng, valid=None):
    """Per in-lane with two or more valid out-links: every such out-link's
    ring tail placed at one distance with one template, so all tie on the
    raw distance and on dis - len; for a quarter of those in-lanes the
    out-link rings but the first emptied instead. Returns (st, ties,
    emptied)."""
    cfg = sc.tsim.cfg
    IL, KOUT, G = cfg.IL, cfg.KOUT, cfg.G
    out_src = sc.tb["out_src"].reshape(IL, KOUT, G)
    valid = (sc.tb["out_valid_g"] if valid is None else valid) > 0
    lk_len = sc.tb["lk_len"]
    ties, emptied, used = 0, 0, set()
    for il in range(IL):
        for g in range(G):
            lks = [int(out_src[il, k, g]) for k in range(KOUT)
                   if out_src[il, k, g] >= 0 and valid[il, k, g]]
            lks = [lk for lk in lks if lk not in used]
            if len(lks) < 2:
                continue
            used.update(lks)
            if rng.random() < 0.25:
                for lk in lks[1:]:
                    st["n_k"][lk] = 0
                emptied += 1
                continue
            d = np.float32(rng.uniform(0.5, 0.8) * min(lk_len[lk]
                                                      for lk in lks))
            tpl = int(rng.integers(0, cfg.TP))
            for lk in lks:
                n = max(int(st["n_k"][lk]), 1)
                st["n_k"][lk] = n
                st["k_dis"][n - 1, lk] = d
                st["k_speed"][n - 1, lk] = np.float32(rng.uniform(0, 6))
                st["k_uid"][n - 1, lk] = 70000 + lk
                if "k_tpl" in st:
                    st["k_tpl"][n - 1, lk] = tpl
                if n > 1:           # keep the ring ordered
                    st["k_dis"][:n - 1, lk] = np.maximum(
                        st["k_dis"][:n - 1, lk], d + np.float32(8.0))
            ties += 1
    return st, ties, emptied


def _fill_lane(sc, st):
    """The longest lane holding a vehicle made a full ring (n = SL): its
    front vehicle copied down the ring at a spacing that fits the lane.
    Returns the lane."""
    cfg = sc.tsim.cfg
    SL = cfg.SL
    ln_len = sc.tb["ln_len"]
    cand = np.nonzero(st["n_l"] > 0)[0]
    lane = int(cand[np.argmax(ln_len[cand])])
    n0 = int(st["n_l"][lane])
    tpl = int(st["l_tpl"][0, lane]) if "l_tpl" in st else 0
    gap = np.float32(cfg.params[P_MINGAP]) if cfg.uniform else \
        np.float32(sc.tb["tpl_params"][tpl, P_MINGAP])
    spacing = min(np.float32(_len_of(sc, tpl) + gap),
                  np.float32(st["l_dis"][n0 - 1, lane] / max(SL - n0, 1)))
    skip = ("l_dis", "l_uid", "l_pri", "l_speed")
    for s in range(n0, SL):
        for k, v in st.items():
            if k.startswith("l_") and isinstance(v, np.ndarray) \
                    and v.ndim >= 2 and v.shape[-2:] == (SL, cfg.LNp) \
                    and k not in skip and k not in ("l_rnrow", "l_auxrow"):
                v[s, lane] = v[0, lane]
        for k in ("l_rnrow", "l_auxrow"):
            if k in st:
                st[k][:, s, lane] = st[k][:, 0, lane]
        st["l_dis"][s, lane] = np.float32(
            st["l_dis"][n0 - 1, lane] - spacing * (s - n0 + 1))
        st["l_speed"][s, lane] = np.float32(0.5 * (s % 3))
        st["l_uid"][s, lane] = 80000 + s
        st["l_pri"][s, lane] = 1000 + s
        if "l_sh" in st:
            st["l_sh"][s, lane] = False
            st["l_chg"][s, lane] = False
            st["l_dir"][s, lane] = 0
    st["n_l"][lane] = SL
    return lane


def _empty_rings(st, rng):
    """One busy lane and one busy link emptied."""
    busy_l = np.nonzero(st["n_l"] > 1)[0]
    busy_k = np.nonzero(st["n_k"] > 0)[0]
    if len(busy_l) > 1:
        st["n_l"][busy_l[rng.integers(0, len(busy_l))]] = 0
    if len(busy_k):
        st["n_k"][busy_k[rng.integers(0, len(busy_k))]] = 0


def _fx_to_port(jfx):
    out = {}
    for k, v in jfx.items():
        a = np.array(v)
        dt = torch.bool if a.dtype == np.bool_ else (
            torch.int32 if np.issubdtype(a.dtype, np.integer)
            else torch.float32)
        out[k] = torch.as_tensor(a).to(dt)[..., None].contiguous()
    return out


@pytest.mark.parametrize("name", ["lc", "mixed_lc"])
def test_front_context_and_gap_refresh_match_jax_on_tied_tails(scen, name):
    """R5's lane-change mode (through ring.lc_front_ctx) and R6 (through
    ring_lc.refresh_gaps) against the JAX package's lc_front_ctx and
    refresh_gaps, on a state whose out-link tails tie exactly, some of
    whose out-link rings are empty and some of whose out-links are marked
    invalid: every entry of the context, and the refreshed l_gap /
    k_gap."""
    sc = scen(name)
    cfg = sc.tsim.cfg
    rng = np.random.default_rng(11)
    jt, tt, valid = _invalidate(sc, rng)
    assert (valid <= 0).any()
    st = {k: (v.copy() if isinstance(v, np.ndarray) else v)
          for k, v in sc.leaves.items()}
    # ties among the valid out-links, and a tail on the invalid ones
    st, ties, emptied = _tie_tails(sc, st, rng, valid)
    assert ties >= 1 and emptied + ties >= 2, (ties, emptied)
    jst = _jstate(st)
    jfx = jax_ring.lc_front_ctx(jt, sc.jsim.cfg, jst)
    tst = ring_state_from_numpy(st, "cpu").map(lambda x: x[..., None])
    tfx = ring.lc_front_ctx(tt, cfg, tst)
    assert set(jfx) == set(tfx)
    for k, v in jfx.items():
        assert_close(f"fx {k}", v, tfx[k][..., 0].numpy())
    # the ties reach the min: some lane front's winner is a tied tail
    assert bool(tfx["best_ex"].any())
    jrs = jax_lc.refresh_gaps(jt, sc.jsim.cfg, jst, jfx)
    trs = ring_lc.refresh_gaps(tt, cfg, tst, _fx_to_port(jfx))
    for k in ("l_gap", "k_gap"):
        assert_close(f"refresh {k}", getattr(jrs, k),
                     getattr(trs, k)[..., 0].numpy())
    # and from the port's own context (R5 -> R6 as the step chains them)
    trs2 = ring_lc.refresh_gaps(tt, cfg, tst, tfx)
    for k in ("l_gap", "k_gap"):
        assert_close(f"refresh chained {k}", getattr(jrs, k),
                     getattr(trs2, k)[..., 0].numpy())


@pytest.mark.parametrize("name", ["4x4", "lc", "mixed", "mixed_lc"])
def test_step_outputs_match_jax_on_full_empty_and_tied_rings(scen, name):
    """p1 (its state and every `mid` entry: the forward exchange R7 packs,
    the approach rows R5 feeds, the lane and link rows of K3's
    ring-leader mode) and p2 (the committed state, through R7's entrant
    and candidate packs) against JAX's, from one state with a full lane
    ring, emptied rings, tied out-link tails and out-links marked
    invalid."""
    sc = scen(name)
    cfg = sc.tsim.cfg
    rng = np.random.default_rng(5)
    jt, tt, valid = _invalidate(sc, rng)
    st = {k: (v.copy() if isinstance(v, np.ndarray) else v)
          for k, v in sc.leaves.items()}
    _empty_rings(st, rng)
    st, ties, _ = _tie_tails(sc, st, rng, valid)
    lane = _fill_lane(sc, st)
    assert int(st["n_l"][lane]) == cfg.SL and ties >= 1
    rs1, mid = jax_ring.ring_step_p1(jt, sc.jsim.cfg, _jstate(st),
                                     sc.jsim.q)
    rs1 = jax_leaves(rs1)
    trs1, tmid = ring.ring_step_p1(tt, cfg, ring_state_from_numpy(st, "cpu"),
                                   sc.tsim.q)
    for k, v in rs1.items():
        assert_close(f"p1 {k}", v, getattr(trs1, k).numpy())
    # the port's mid also keeps L4's match for p2 (JAX's p2 searches
    # again)
    assert set(mid) == set(tmid) - set(ring.LC_MATCH_KEYS)
    for k, v in mid.items():
        assert_close(f"mid {k}", v, tmid[k].numpy())
    # the full ring's front slots and tail moved through K3's ring mode
    assert float(np.abs(np.asarray(mid["new_dis_l"])[:, lane]
                        - st["l_dis"][:, lane]).max()) > 0
    mid_np = {k: np.array(v) for k, v in mid.items()}
    want = jax_leaves(jax_ring.ring_step_p2(
        jt, sc.jsim.cfg, _jstate(rs1),
        {k: jnp.asarray(v) for k, v in mid_np.items()}))
    got = ring.ring_step_p2(tt, cfg, ring_state_from_numpy(rs1, "cpu"),
                            p2_mid(mid_np, tmid))
    for k, v in want.items():
        g = getattr(got, k).numpy()
        if k == "cum_travel":
            np.testing.assert_allclose(g, v, rtol=1e-6, atol=0, err_msg=k)
        else:
            assert_close(f"p2 {k}", v, g)


@pytest.mark.parametrize("name", ["4x4", "mixed_lc"])
def test_batched_step_equals_each_env_alone_bitwise(scen, name):
    """Three envs from different states (one with a full lane ring) in one
    batched step equal each env stepped alone, bit for bit, over 6 steps:
    the packs, the front leaders and K3's ring reads stay within their
    env column."""
    sc = scen(name)
    cfg = sc.tsim.cfg
    rng = np.random.default_rng(3)
    states = [{k: (v.copy() if isinstance(v, np.ndarray) else v)
               for k, v in sc.leaves.items()} for _ in range(3)]
    _fill_lane(sc, states[1])
    _empty_rings(states[2], rng)
    _tie_tails(sc, states[2], rng)
    singles = [ring_state_from_numpy(s, "cpu") for s in states]
    b = ring.RingState(**{k: torch.stack([getattr(s, k) for s in singles],
                                         -1).contiguous()
                          for k in singles[0].leaves()})
    for _ in range(6):
        b = ring.ring_step_batched(sc.tsim.tables, cfg, b, sc.tsim.q)
        singles = [ring.ring_step(sc.tsim.tables, cfg, s, sc.tsim.q)
                   for s in singles]
        for e, s in enumerate(singles):
            for k, v in s.leaves().items():
                assert torch.equal(getattr(b, k)[..., e], v), (e, k)


def test_an_in_lane_without_a_lane_reads_the_fill(scen):
    """config_4x4.json with one in-lane's lane taken out of the tables
    (in_src -1, the lane's in_inv -1): R7's forward pack writes +0.0 in
    every channel of that in-lane, its entrant pack gives the links it
    starts nothing, R5's approach mode reads no next link for it (v_isr
    0, isr_rel and has_lead off past slot 0), and every other column is
    as with the full tables."""
    sc = scen("4x4")
    cfg = sc.tsim.cfg
    B = 2
    st = ring.batch_ring_state(ring_state_from_numpy(sc.leaves, "cpu"), B)
    j = int(np.nonzero(sc.leaves["n_l"][sc.tb["in_src"].reshape(-1)] > 0)[0][0])
    lane = int(sc.tb["in_src"].reshape(-1)[j])
    in_src = sc.tb["in_src"].copy().reshape(-1)
    in_src[j] = -1
    in_inv = sc.tb["in_inv"].copy()
    in_inv[lane] = -1
    cut = dict(sc.tsim.tables, in_src=torch.as_tensor(in_src.reshape(
        sc.tb["in_src"].shape)), in_inv=torch.as_tensor(in_inv))
    full = sc.tsim.tables
    inl_f = ring.pack_forward(cfg, full, st)
    inl_c = ring.pack_forward(cfg, cut, st)
    assert bool((inl_f[:, j] != 0).any())
    assert torch.equal(inl_c[:, j], torch.zeros_like(inl_c[:, j]))
    assert not bool(torch.signbit(inl_c[:, j]).any())
    keep = torch.arange(inl_c.shape[1]) != j
    assert torch.equal(inl_c[:, keep], inl_f[:, keep])
    AP, LPI, G = cfg.AP, cfg.LPI, cfg.G
    exited = torch.ones((cfg.XK, cfg.LNp, B), dtype=torch.bool)
    ap = torch.full((AP, cfg.IL, G, B), 3.0)
    ent_c = ring.pack_entrants(cfg, cut, inl_c, exited, ap_dis=ap, ap_spd=ap)
    starts = torch.as_tensor(sc.tb["start_src"] == j)
    assert bool(starts.any())
    assert torch.equal(ent_c[:, :, starts], torch.zeros_like(
        ent_c[:, :, starts]))
    et = torch.zeros((6, cfg.LKp, B))
    v_isr = torch.full((AP, LPI, G, B), 7.0)
    rel = torch.ones((AP, LPI, G, B), dtype=torch.bool)
    fl = ring.front_leaders(cfg, cut, st, inl_c, et, v_isr, rel)
    col = lambda x: x.reshape(AP, -1, B)[:, j]
    assert torch.equal(col(fl["v_isr"]), torch.zeros((AP, B)))
    assert not bool(col(fl["isr_rel"]).any())
    assert not bool(col(fl["has_lead"])[1:].any())
