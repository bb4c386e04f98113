"""The ring step's regions R1-R4 of the PyTorch port (kernels/
notify_winners.py, ring_exits.py, ring_admit.py, route_rows.py: on the CPU
their plain versions) against the JAX package's step, on seeded states
crafted to reach their edges: blocker chains and cycles around the k_cyc
walk, link tails tied with the cross distance, full entry lanes, a tail
exactly at length + minGap, cursors at the queue's end, the three
admission-gap branches, crossings past XK, an aborted shadow and a
finished change in one step, more exits at an intersection than TI.

Each JAX run is one module fixture per scenario; every comparison starts
both steps from the same numpy state, held to test_torch_ring.py's
tolerances (ints and bools equal, float32 within 1e-5; cum_travel within
1e-6 relative, a float sum taken in another order).
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

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.carry import ring_state_from_numpy
from cityflow_tpu_torch.compiler.net import (
    P_LEN, P_MINGAP, compile_scenario)
from cityflow_tpu_torch.core import ring
from cityflow_tpu_torch.core.state import OV_HOPS, OV_REMOVE, OV_SLOTS
from test_torch_ring import assert_close, jax_leaves, p2_mid

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
SCEN = {
    "4x4": ("config_4x4.json", {}),
    "mixed": ("config_2x2_mixed.json", dict(skc=99)),
    "lc": ("config_1x1s_lc.json", dict(sl=12, sk=6, skc=99)),
}
AT = {"4x4": 30, "mixed": 60, "lc": 40}


def _jstate(leaves):
    """numpy leaves -> the JAX package's RingState."""
    return jax_ring.RingState(**{
        f.name: None if leaves.get(f.name) is None
        else jnp.asarray(leaves[f.name])
        for f in dataclasses.fields(jax_ring.RingState)})


def _np_mid(mid):
    return {k: np.array(v) for k, v in mid.items()}


class _Run:
    """One scenario: both sims, and JAX's states phase by phase."""

    def __init__(self, name):
        cfg_file, kw = SCEN[name]
        path = os.path.join(FIX, cfg_file)
        steps = AT[name] + 4
        self.jsim = jax_ring_sim.build_sim(jax_compile(path),
                                           horizon=steps + 8, **kw)
        self.tsim = ring_sim.build_sim(compile_scenario(path),
                                       horizon=steps + 8, device="cpu", **kw)
        self.states, st = [], self.jsim.state
        for _ in range(steps):
            rs1, mid = self.p1_jax(jax_leaves(st))
            self.states.append((jax_leaves(st), rs1, mid))
            st = jax_ring.ring_step_p2(self.jsim.tables, self.jsim.cfg,
                                       _jstate(rs1), mid)

    def tables(self, **tb):
        """(JAX's, the port's) tables with the given numpy ones replaced."""
        return (dict(self.jsim.tables,
                     **{k: jnp.asarray(v) for k, v in tb.items()}),
                dict(self.tsim.tables,
                     **{k: torch.as_tensor(v) for k, v in tb.items()}))

    def p1_jax(self, leaves, cfg=None, tabs=None):
        rs1, mid = jax_ring.ring_step_p1(
            tabs or self.jsim.tables, cfg or self.jsim.cfg, _jstate(leaves),
            self.jsim.q)
        return jax_leaves(rs1), _np_mid(mid)

    def p2_jax(self, rs1, mid, cfg=None, tabs=None):
        return jax_leaves(jax_ring.ring_step_p2(
            tabs or self.jsim.tables, cfg or self.jsim.cfg, _jstate(rs1),
            {k: jnp.asarray(v) for k, v in mid.items()}))

    def p1_port(self, leaves, cfg=None, tabs=None):
        return ring.ring_step_p1(tabs or self.tsim.tables,
                                 cfg or self.tsim.cfg,
                                 ring_state_from_numpy(leaves, "cpu"),
                                 self.tsim.q)

    def p2_port(self, rs1, mid, tmid, cfg=None, tabs=None):
        """p2 from JAX's state and mid, with the L4 match of the port's p1
        mid `tmid` (from the state p1 ran on)."""
        return ring.ring_step_p2(tabs or self.tsim.tables,
                                 cfg or self.tsim.cfg,
                                 ring_state_from_numpy(rs1, "cpu"),
                                 p2_mid(mid, tmid))


_RUNS = {}


def _run(name):
    if name not in _RUNS:
        _RUNS[name] = _Run(name)
    return _RUNS[name]


@pytest.fixture(scope="module")
def runs():
    yield _run
    _RUNS.clear()


def _check_p1(run, leaves, cfg_j=None, cfg_t=None, tabs=(None, None)):
    rs1, mid = run.p1_jax(leaves, cfg_j, tabs[0])
    trs1, tmid = run.p1_port(leaves, cfg_t, tabs[1])
    for k, v in rs1.items():
        assert_close(f"p1 {k}", v, getattr(trs1, k).numpy())
    # the port's mid also keeps L4's match for p2 (JAX's p2 searches
    # again)
    assert set(mid) == set(tmid) - set(ring.LC_MATCH_KEYS)
    for k, v in mid.items():
        assert_close(f"mid {k}", v, tmid[k].numpy())
    return rs1, mid, tmid


def _check_p2(run, rs1, mid, tmid, cfg_j=None, cfg_t=None,
              tabs=(None, None)):
    want = run.p2_jax(rs1, mid, cfg_j, tabs[0])
    got = run.p2_port(rs1, mid, tmid, cfg_t, tabs[1])
    for k, v in want.items():
        g = getattr(got, k).numpy()
        if k == "cum_travel":
            np.testing.assert_allclose(g, v, rtol=1e-6, atol=0, err_msg=k)
        else:
            assert_close(f"p2 {k}", v, g)
    return want


# ---------------------------------------------------------------------------
# R1: notify winners and the blocker-cycle flag
# ---------------------------------------------------------------------------

def _blocker_patterns(LPI, G, k_cyc, rng):
    """blk (LPI, G): per intersection one seeded pattern: cycles of length
    1, 2, the walk's k_cyc + 1 and its neighbours, 15, 16, 17; chains that
    reach -1 after those many hops; a chain into an index >= LPI. The
    intersection's other links pair up in 2-cycles."""
    walk = k_cyc + 1
    kinds = [("cycle", n) for n in (1, 2, walk - 1, walk, walk + 1, 15, 16,
                                    17)] \
        + [("chain", n) for n in (walk - 1, walk, walk + 1, 15, 16, 17)] \
        + [("out", walk)]
    blk = np.full((LPI, G), -1, np.int32)
    for g in range(G):
        kind, n = kinds[g % len(kinds)]
        order = rng.permutation(LPI)
        for i in range(n):
            blk[order[i], g] = order[i + 1]
        if kind == "cycle":
            blk[order[n - 1], g] = order[0]
        elif kind == "out":
            blk[order[n - 1], g] = LPI + int(rng.integers(0, 8))
        rest = order[n + 1:]
        for i in range(0, len(rest) - 1, 2):
            blk[rest[i], g], blk[rest[i + 1], g] = rest[i + 1], rest[i]
    return blk, len(kinds)


def _tie(d, p_len):
    """A float32 k_dis whose tail k_dis - len is exactly d, or None."""
    x = np.float32(d + p_len)
    for _ in range(4):
        if np.float32(x - p_len) == d:
            return x
        x = np.nextafter(x, np.float32(np.inf), dtype=np.float32)
    return None


def _crowd_links(run, st, rng):
    """st with a vehicle put on most empty links (the fixture's links are
    nearly empty), a third of them with the tail tied exactly at one of
    the link's cross distances, so that crosses see foes."""
    cfg = run.tsim.cfg
    KC, LKp = cfg.KC, cfg.LKp
    tb = {k: v.numpy() for k, v in run.tsim.tables.items()}
    p_len = np.float32(cfg.params[P_LEN])
    d = tb["lk_d"].reshape(KC, LKp)
    cvalid = tb["lk_cvalid"].reshape(KC, LKp)
    st = {k: (v.copy() if isinstance(v, np.ndarray) else v)
          for k, v in st.items()}
    step = int(st["step"])
    routes = st["l_route"][:, st["n_l"] > 0]
    tied = 0
    for lk in np.nonzero(st["n_k"] == 0)[0]:
        if rng.random() < 0.3:
            continue
        st["n_k"][lk] = 1
        cs = np.nonzero(cvalid[:, lk])[0]
        x = _tie(d[rng.choice(cs), lk], p_len) \
            if len(cs) and rng.random() < 0.35 else None
        tied += x is not None
        st["k_dis"][0, lk] = x if x is not None else np.float32(
            rng.uniform(0.0, tb["lk_len"][lk]))
        st["k_speed"][0, lk] = np.float32(rng.uniform(0.0, 8.0))
        st["k_entll"][0, lk] = step - int(rng.integers(1, 10))
        st["k_pri"][0, lk] = int(rng.integers(0, 1 << 20))
        st["k_uid"][0, lk] = 50000 + lk
        st["k_route"][0, lk] = routes.flat[rng.integers(0, routes.size)]
        st["k_rpos"][0, lk] = 1
        st["k_enter"][0, lk] = np.float32(step - 20)
        st["k_nxtl"][0, lk] = tb["lk_end_lane"][lk]
    return st, tied


def test_notify_winners_on_blocker_chains_and_tied_tails(runs):
    """config_4x4.json at step 30: blk overwritten by seeded chains and
    cycles around the k_cyc walk, 15-17 hops and indices >= LPI, the
    links crowded with tails tied at their cross distances. The blockers
    reach the step (k_fail moves with them), and JAX and the port agree
    phase by phase."""
    run = runs("4x4")
    cfg = run.tsim.cfg
    LPI, G, LKp = cfg.LPI, cfg.G, cfg.LKp
    rng = np.random.default_rng(7)
    st, tied = _crowd_links(run, run.states[AT["4x4"]][0], rng)
    assert tied >= 20, tied
    blk, nkinds = _blocker_patterns(LPI, G, cfg.k_cyc, rng)
    assert G >= nkinds
    crafted = dict(st, blk=blk.reshape(LKp))
    # the crafted blockers reach the step: the first-failing flags move
    _, base_mid = run.p1_port(dict(st, blk=np.full(LKp, -1, np.int32)))
    _, mid = run.p1_port(crafted)
    assert base_mid["k_fail"].any()
    assert not torch.equal(base_mid["k_fail"], mid["k_fail"])
    # and JAX and the port agree on them, phase by phase
    rs1, jmid, tmid = _check_p1(run, crafted)
    _check_p2(run, rs1, jmid, tmid)


# ---------------------------------------------------------------------------
# R3: spawn and admission
# ---------------------------------------------------------------------------

def _due_entries(run, st):
    """Entry lanes whose queue row at the cursor is due."""
    q = {k: v.numpy() for k, v in run.tsim.q.items()}
    cur = st["el_cursor"]
    QCAP = q["step"].shape[1]
    row = q["step"][np.arange(len(cur)), np.clip(cur, 0, QCAP - 1)]
    return np.nonzero((cur < QCAP) & (row >= 0) & (row <= st["step"]))[0], q


def _admission_edges(run, st, rng):
    """A full entry lane with a due row and room behind its tail
    (OV_SLOTS), a tail exactly at length + minGap, a cursor at QCAP."""
    cfg = run.tsim.cfg
    tb = {k: v.numpy() for k, v in run.tsim.tables.items()}
    el = tb["el_lane"]
    st = {k: (v.copy() if isinstance(v, np.ndarray) else v)
          for k, v in st.items()}
    due, q = _due_entries(run, st)
    assert len(due) >= 3, "the state should have a queue at 3 entries"
    e_full, e_tie, e_end = rng.choice(due, 3, replace=False)
    SL = cfg.SL
    # full: SL vehicles spaced down the lane, the rear one well clear
    p = el[e_full]
    n = int(st["n_l"][p])
    ln_len = tb["ln_len"][p]
    st["l_dis"][:, p] = np.linspace(ln_len - 1.0, 30.0, SL,
                                    dtype=np.float32)
    for s in range(max(n, 1), SL):
        for k in ("l_speed", "l_flow", "l_route", "l_rpos", "l_nxt",
                  "l_nxt3", "l_prev", "l_enter", "l_pri", "l_last",
                  "l_tpl"):
            if st.get(k) is not None:
                st[k][s, p] = st[k][max(n - 1, 0), p]
        st["l_uid"][s, p] = 100000 + s
    st["n_l"][p] = SL
    # tie: the tail exactly at its length + the incoming vehicle's minGap
    p = el[e_tie]
    if st["n_l"][p] == 0:
        st["n_l"][p] = 1
    t = int(st["n_l"][p]) - 1
    tp = tb["tpl_params"]
    if cfg.uniform:
        t_len, mingap = tp[0, P_LEN], tp[0, P_MINGAP]
    else:
        t_len = tp[st["l_tpl"][t, p], P_LEN]
        mingap = tp[q["tpl"][e_tie, st["el_cursor"][e_tie]], P_MINGAP]
    st["l_dis"][t, p] = np.float32(t_len) + np.float32(mingap)
    # a cursor at the queue's end
    st["el_cursor"][e_end] = q["step"].shape[1]
    return st, (e_full, e_tie, e_end)


def test_admission_edges_with_templates(runs):
    """config_2x2_mixed.json: the template lengths and minGaps decide."""
    run = runs("mixed")
    rng = np.random.default_rng(3)
    st, (e_full, e_tie, e_end) = _admission_edges(
        run, run.states[AT["mixed"]][0], rng)
    rs1, mid, tmid = _check_p1(run, st)
    el_cur = rs1["el_cursor"]
    assert el_cur[e_full] == st["el_cursor"][e_full]       # refused
    assert el_cur[e_tie] == st["el_cursor"][e_tie]         # tied: refused
    assert el_cur[e_end] == st["el_cursor"][e_end]         # no row
    assert int(mid["ov"]) & OV_SLOTS
    assert (el_cur > st["el_cursor"]).sum() > 0            # others admit
    _check_p2(run, rs1, mid, tmid)


def _gap_branches(run, st, rs1, tb):
    """Admissions into empty entry lanes by the admission-gap branch
    taken: out-link ring tail (1), the first link's end-lane tail within
    the lookahead (2), neither (0)."""
    cfg = run.tsim.cfg
    ts = ring.batch_ring_state(ring_state_from_numpy(st, "cpu"), 1)
    fx = ring.lc_front_ctx(tb, cfg, ts, ring._Ctx(tb, cfg, "cpu"))
    el = tb["el_lane"].numpy()
    best_ex = fx["best_ex"][:, 0].numpy()[el]
    adm = rs1["el_cursor"] > st["el_cursor"]
    empty = adm & (st["n_l"][el] == 0)
    gap0 = rs1["l_gap"][0, el]
    return {1: int((empty & best_ex).sum()),
            2: int((empty & ~best_ex & (gap0 != 0)).sum()),
            0: int((empty & ~best_ex & (gap0 == 0)).sum())}


def test_admission_edges_and_gap_branches_with_lane_change(runs):
    """config_1x1s_lc.json: the tail edges, then entry lanes emptied so
    that the admission-time gap takes each of its three branches. The
    fixture's entry lanes (90 m) are longer than the lookahead (64 m), so
    for the end-lane branch the states with emptied out-links run on a
    net whose entry lanes are 2 m long (the links are 60 m), the same for
    both steps."""
    run = runs("lc")
    cfg = run.tsim.cfg
    rng = np.random.default_rng(5)
    seen = {0: 0, 1: 0, 2: 0}
    el = run.tsim.tables["el_lane"].numpy()
    ln_len = run.tsim.tables["ln_len"].numpy().copy()
    ln_len[el] = 2.0
    short = run.tables(ln_len=ln_len)
    for t in range(AT["lc"] - 12, AT["lc"] + 1, 3):
        st = run.states[t][0]
        tabs = (None, None)
        if t == AT["lc"]:
            st, _ = _admission_edges(run, st, rng)
        else:
            st = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                  for k, v in st.items()}
            # empty the due entry lanes; on every other one also its
            # out-links' rings, so the scan reaches past them
            due, _ = _due_entries(run, st)
            st["n_l"][el[due]] = 0
            if t % 2:
                lk_start = run.tsim.tables["start_src"].numpy()
                in_src = run.tsim.tables["in_src"].numpy().reshape(-1)
                from_lane = np.where(lk_start >= 0,
                                     in_src[np.clip(lk_start, 0, None)], -1)
                st["n_k"][np.isin(from_lane, el[due])] = 0
                tabs = short
        rs1, mid, tmid = _check_p1(run, st, tabs=tabs)
        for k, v in _gap_branches(run, st, rs1,
                                  tabs[1] or run.tsim.tables).items():
            seen[k] += v
        _check_p2(run, rs1, mid, tmid, tabs=tabs)
    assert all(v > 0 for v in seen.values()), seen
    assert cfg.lane_change


# ---------------------------------------------------------------------------
# R2: exits, removals, pair flags; R4: route rows
# ---------------------------------------------------------------------------

def test_exits_abort_and_finish_in_one_step_and_deep_crossings(runs):
    """config_1x1s_lc.json: a step where a change finishes, with a
    changing real made to cross its lane's end, so that its shadow aborts
    mid-ring, and a lane whose XK + 1 front slots cross (OV_HOPS);
    finished_cnt exact, cum_travel within 1e-6 relative."""
    run = runs("lc")
    cfg = run.tsim.cfg
    XK = cfg.XK
    ln_len = run.tsim.tables["ln_len"].numpy()
    events = {}
    orig = ring.ring_exits_finish

    def spy(cfg_, net, rs, leave, abort_sh, finish_pre, pAb, pFin, pf,
            *a):
        out = orig(cfg_, net, rs, leave, abort_sh, finish_pre, pAb, pFin,
                   pf, *a)
        events["abort"] = int(((abort_sh > 0.5) & ~leave).sum())
        events["finish"] = int(((finish_pre > 0.5)
                                & ~(pf & (pAb > 0.5))).sum())
        return out
    tb = {k: v.numpy() for k, v in run.tsim.tables.items()}
    in_src = tb["in_src"].reshape(-1)
    start = tb["start_src"]
    from_lane = np.where(start >= 0, in_src[np.clip(start, 0, None)], -1)
    done = False
    for t in range(5, len(run.states)):
        st0, rs1, mid = run.states[t]
        occ = np.arange(cfg.SL)[:, None] < rs1["n_l"][None]
        real = occ & rs1["l_chg"] & ~rs1["l_sh"]
        real[XK:] = False
        if real.any():
            _, tmid = run.p1_port(st0)
        for s, p in np.argwhere(real):
            # the real heads into a link (not its route's end: the
            # fixture changes lanes on last roads, so the pair's flags and
            # next hop are set), crosses its lane's end with the slots
            # before it, and its shadow aborts
            rs = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                  for k, v in rs1.items()}
            pair = (rs["l_uid"] == rs["l_uid"][s, p]) & occ
            rs["l_last"][pair] = False
            if rs["l_nxt"][s, p] < 0:
                own = np.nonzero(from_lane == p)[0]
                rs["l_nxt"][s, p] = cfg.LNp + (int(own[0]) if len(own)
                                               else 0)
            m = {k: v.copy() for k, v in mid.items()}
            nd = m["new_dis_l"]
            nd[:s + 1, p] = ln_len[p] + 1.0 + np.arange(s + 1, 0, -1)
            deep = np.nonzero((rs["n_l"] > XK)
                              & (np.arange(len(ln_len)) != p))[0]
            if not len(deep):
                continue
            q = int(deep[0])
            nd[:XK + 1, q] = ln_len[q] + 1.0 + np.arange(XK + 1, 0, -1)
            ring.ring_exits_finish = spy
            try:
                want = _check_p2(run, rs, m, tmid)
            finally:
                ring.ring_exits_finish = orig
            assert int(want["overflow"]) & OV_HOPS
            if events["abort"] and events["finish"]:
                assert int(want["finished_cnt"]) > int(rs["finished_cnt"])
                done = True
                break
        if done:
            break
    assert done, "no step with a change, a finish and an abort"


@pytest.mark.parametrize("name", ["4x4", "lc"])
def test_route_rows_with_more_exits_than_ti(runs, name):
    """TI = 2 on both configs, the links crowded as for R1, and the front
    slot of every occupied link of one intersection made to cross: the
    first TI exits in row order get
    their route rows (with lane change also the rn / ax rows), the others
    the fills, and OV_REMOVE is set, as in JAX."""
    run = runs(name)
    cfg_t = dataclasses.replace(run.tsim.cfg, TI=2)
    cfg_j = dataclasses.replace(run.jsim.cfg, TI=2)
    LPI, G, SK = cfg_t.LPI, cfg_t.G, cfg_t.SK
    st, _ = _crowd_links(run, run.states[AT[name]][0],
                         np.random.default_rng(11))
    rs1, mid = run.p1_jax(st)
    lk_len = run.tsim.tables["lk_len"].numpy().reshape(LPI, G)
    n_k = rs1["n_k"].reshape(LPI, G)
    nd = mid["nd_k3"].reshape(SK, LPI, G)
    g = int(np.argmax((n_k > 0).sum(0)))
    occ = n_k[:, g] > 0
    assert occ.sum() > cfg_t.TI, occ.sum()
    nd[0, occ, g] = lk_len[occ, g] + 0.5
    _, tmid = run.p1_port(st)
    want = _check_p2(run, rs1, mid, tmid, cfg_j, cfg_t)
    assert int(want["overflow"]) & OV_REMOVE


# ---------------------------------------------------------------------------
# the entries' state contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config,kw", [
    ("config_4x4.json", {}),
    ("config_1x1s_mixed_lc.json", dict(sl=12, sk=6, skc=99))])
def test_single_env_entries_leave_their_input_state_as_it_was(config, kw):
    """ring_step_p1 / ring_step_p2 / ring_step on one env, and
    batch_ring_state, copy what the batched step writes in place."""
    tsim = ring_sim.build_sim(compile_scenario(os.path.join(FIX, config)),
                              horizon=40, device="cpu", **kw)
    st = tsim.state
    for _ in range(20):
        st = ring.ring_step(tsim.tables, tsim.cfg, st, tsim.q)
    for _ in range(20):      # on to a step that admits
        snap = {k: v.clone() for k, v in st.leaves().items()}
        rs1, mid = ring.ring_step_p1(tsim.tables, tsim.cfg, st, tsim.q)
        if int(rs1.el_cursor.sum()) > int(st.el_cursor.sum()):
            break
        st = ring.ring_step_p2(tsim.tables, tsim.cfg, rs1, mid)
    assert int(rs1.el_cursor.sum()) > int(st.el_cursor.sum())

    def unchanged(what):
        for k, v in st.leaves().items():
            assert torch.equal(v, snap[k]), f"{what} wrote {k}"
    unchanged("ring_step_p1")
    rs1_snap = {k: v.clone() for k, v in rs1.leaves().items()}
    ring.ring_step_p2(tsim.tables, tsim.cfg, rs1, mid)
    for k, v in rs1.leaves().items():
        assert torch.equal(v, rs1_snap[k]), f"ring_step_p2 wrote {k}"
    ring.ring_step(tsim.tables, tsim.cfg, st, tsim.q)
    unchanged("ring_step")
    b = ring.batch_ring_state(st, 1)
    ring.ring_step_batched(tsim.tables, tsim.cfg, b, tsim.q)
    unchanged("a step of batch_ring_state(st, 1)")
