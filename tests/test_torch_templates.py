"""Non-uniform vehicle templates on the ring in the PyTorch port against the
JAX package's, on the CPU, where every kernel wrapper runs its plain
PyTorch version.

Two fixtures, run as the JAX package's own tests run them:
config_2x2_mixed.json (three templates, 200 steps, skc=99;
tests/test_ring.py) and config_1x1s_mixed_lc.json (three templates with
lane change, 80 steps, sl=12, sk=6, skc=99; tests/test_ring_lc.py). JAX's
runs are module fixtures, phase by phase. Integer and bool values must be
equal, float32 ones within 1e-5 (per phase) or 2e-3 (free trajectories).
On this path JAX divides by per-slot parameter arrays, not by
compile-time constants; the per-phase test records which float leaves
were not bitwise all the same (ROADMAP.md queue 3).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cityflow_tpu import ring_sim as jax_ring_sim
from cityflow_tpu.compiler.net import compile_scenario as jax_compile
from cityflow_tpu.core import ring as jax_ring
from cityflow_tpu.core import ring_lc as jax_lc
from cityflow_tpu.rl.env import RingVecEnv as JaxRingVecEnv

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.carry import ring_state_from_numpy
from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.core import ring, ring_lc
from cityflow_tpu_torch.kernels import car_follow, lc_insert, tpl_params
from cityflow_tpu_torch.rl.env import RingVecEnv
from test_torch_ring import (assert_close, jax_leaves, p2_mid, port_leaves,
                             vehicles)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
MIXED = os.path.join(FIX, "config_2x2_mixed.json")
MIXED_KW = dict(skc=99)
MIXED_STEPS = 200
MIXED_LC = os.path.join(FIX, "config_1x1s_mixed_lc.json")
MIXED_LC_KW = dict(sl=12, sk=6, skc=99)
MIXED_LC_STEPS = 80


class _Quiet(tuple):
    """A fixture value with a short repr: a failing test's report prints
    its arguments, and the reprs of the sims and runs take minutes."""

    def __repr__(self):
        return f"<{len(self)} items>"


def _pair(config, steps, **kw):
    jsim = jax_ring_sim.build_sim(jax_compile(config), horizon=steps + 8,
                                  **kw)
    tsim = ring_sim.build_sim(compile_scenario(config), horizon=steps + 8,
                              device="cpu", **kw)
    return _Quiet((jsim, tsim))


def _jax_run(jsim, steps):
    """JAX's steps phase by phase, as numpy: for each step the state it
    starts from, p1's (rs, mid) and p2's state."""
    run, st = [], jsim.state
    for _ in range(steps):
        rs1, mid = jax_ring.ring_step_p1(jsim.tables, jsim.cfg, st, jsim.q)
        st2 = jax_ring.ring_step_p2(jsim.tables, jsim.cfg, rs1, mid)
        run.append((jax_leaves(st), jax_leaves(rs1),
                    {k: np.asarray(v) for k, v in mid.items()}, st2))
        st = st2
    return _Quiet((a, b, c, jax_leaves(d)) for a, b, c, d in run)


@pytest.fixture(scope="module")
def mixed_pair():
    return _pair(MIXED, MIXED_STEPS, **MIXED_KW)


@pytest.fixture(scope="module")
def jax_mixed_run(mixed_pair):
    return _jax_run(mixed_pair[0], MIXED_STEPS)


@pytest.fixture(scope="module")
def lc_pair():
    return _pair(MIXED_LC, MIXED_LC_STEPS, **MIXED_LC_KW)


@pytest.fixture(scope="module")
def jax_lc_run(lc_pair):
    return _jax_run(lc_pair[0], MIXED_LC_STEPS)


@pytest.fixture(params=["mixed", "mixed_lc"])
def case(request):
    """(pair, JAX run) of one fixture."""
    if request.param == "mixed":
        return _Quiet((request.getfixturevalue("mixed_pair"),
                       request.getfixturevalue("jax_mixed_run")))
    return _Quiet((request.getfixturevalue("lc_pair"),
                   request.getfixturevalue("jax_lc_run")))


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def test_build_matches_jax(mixed_pair, lc_pair):
    """Config, template table, queues (with the tpl column) and the
    initial state equal JAX's; the scalar parameters are NaN."""
    for jsim, tsim in (mixed_pair, lc_pair):
        jc, tc = jsim.cfg, tsim.cfg
        assert not tc.uniform and tc.TP == jc.TP == 3
        for k in ("SL", "SK", "AP", "XK", "SA", "SKC", "lane_change",
                  "MAXLPR"):
            assert getattr(tc, k) == getattr(jc, k), k
        assert all(np.isnan(tc.params)) and len(tc.params) == 12
        np.testing.assert_array_equal(tsim.tables["tpl_params"].numpy(),
                                      np.asarray(jsim.tables["tpl_params"]))
        assert set(tsim.q) == set(jsim.q) and "tpl" in tsim.q
        for k, v in jsim.q.items():
            np.testing.assert_array_equal(tsim.q[k].numpy(), np.asarray(v),
                                          err_msg=k)
        assert len(np.unique(np.asarray(jsim.q["tpl"]))) == 3
        want = jax_leaves(jsim.state)
        got = port_leaves(tsim.state)
        assert set(want) == set(got) and {"l_tpl", "k_tpl"} <= set(got)
        for k, v in want.items():
            assert_close(f"init {k}", v, got[k])
    # the shadow-insert cap: JAX's 2, but with lane change and templates
    # the most the mixed 30x30 lane-change grid asks of one lane in one
    # step (more than 2), within what L3 takes
    assert mixed_pair[1].cfg.LCI == mixed_pair[0].cfg.LCI == 2
    assert lc_pair[1].cfg.LCI == ring_sim.TEMPLATE_LCI == 4
    assert ring_sim.TEMPLATE_LCI <= lc_insert.MAX_LCI


# ---------------------------------------------------------------------------
# per phase, from JAX's state
# ---------------------------------------------------------------------------

def test_per_phase_matches_jax(case):
    """Both phases of every step, each from JAX's state: int and bool
    leaves and mid entries equal (l_tpl / k_tpl included), float32 within
    1e-5, and, recorded, bitwise."""
    (_, tsim), run = case
    not_bitwise = set()
    for t, (st, rs1, mid, st2) in enumerate(run):
        trs1, tmid = ring.ring_step_p1(
            tsim.tables, tsim.cfg, ring_state_from_numpy(st, "cpu"), tsim.q)
        for k, v in rs1.items():
            assert_close(f"step {t} p1 {k}", v, getattr(trs1, k).numpy(),
                         not_bitwise)
        # the port's mid also keeps L4's match for p2 (JAX's p2 searches
        # again); p2 below runs from JAX's mid with the port's match
        assert set(mid) == set(tmid) - set(ring.LC_MATCH_KEYS)
        for k, v in mid.items():
            assert_close(f"step {t} mid {k}", v, tmid[k].numpy(),
                         not_bitwise)
        tst2 = ring.ring_step_p2(
            tsim.tables, tsim.cfg, ring_state_from_numpy(rs1, "cpu"),
            p2_mid(mid, tmid))
        for k, v in st2.items():
            assert_close(f"step {t} p2 {k}", v, getattr(tst2, k).numpy(),
                         not_bitwise)
    last = run[-1][3]
    assert int(last["n_l"].sum() + last["n_k"].sum()) > 10
    assert len(np.unique(last["l_tpl"][:4])) > 1, "one template only"
    if tsim.cfg.lane_change:
        assert sum(bool(r[0]["l_sh"].any()) for r in run) >= 3
    # recorded: the float leaves that were not bitwise; only the speed
    # model's outputs and what they move. XLA's algebraic simplifier
    # rewrites a / (b / c) into a * c / b: noCollisionSpeed's
    # 0.5 / (0.5 / maxNegAcc) becomes maxNegAcc exactly, where IEEE
    # division is one ulp off it for 3.5 (the second template's)
    fields = sorted({name.split()[-1] for name in not_bitwise})
    print("float leaves not bitwise:", fields or "none")
    assert set(fields) <= {"ap_spd", "ap_dis", "new_spd_l", "new_dis_l",
                           "ns_k3", "nd_k3", "l_dis", "l_speed", "k_dis",
                           "k_speed", "l_gap", "k_gap", "l_yv", "l_off"}, \
        fields


# ---------------------------------------------------------------------------
# the kernels' plain versions against JAX's intermediates
# ---------------------------------------------------------------------------

def test_tpl_params_matches_jax_pp(mixed_pair):
    """T1's plain version against JAX's _PP one-hot einsum, on template
    indices of several shapes, out-of-range ones included (zeros there)."""
    jsim, tsim = mixed_pair
    rng = np.random.default_rng(0)
    table = tsim.tables["tpl_params"]
    for shape in ((7,), (5, 6), (3, 4, 5)):
        idx = rng.integers(-1, jsim.cfg.TP + 1, shape).astype(np.int32)
        pp = jax_ring._PP(jsim.cfg, jsim.tables, jnp.asarray(idx))
        cols = tuple(range(12))
        got = tpl_params.tpl_params(torch.as_tensor(idx), table, cols)
        assert got.shape == (12,) + shape
        for i in cols:
            np.testing.assert_array_equal(got[i].numpy(),
                                          np.asarray(pp[i]), err_msg=str(i))
    # a column subset keeps its order
    idx = torch.as_tensor(rng.integers(0, 3, (4, 9)).astype(np.int32))
    got = tpl_params.tpl_params(idx, table, (8, 1))
    assert torch.equal(got[0], table[idx.long(), 8])
    assert torch.equal(got[1], table[idx.long(), 1])
    with pytest.raises(ValueError):
        tpl_params.tpl_params(idx, table, (12,))


def test_kernel_plain_versions_match_jax_intermediates(mixed_pair,
                                                       jax_mixed_run):
    """K2 and K3 in their template modes at the mixed fixture's call-site
    shapes against the JAX intermediates they replace (mid: K2's fail
    flags and first-fail foes on link and approach rows, K3's link speeds
    and distances, approach speeds and lane speeds), at steps with mixed
    traffic."""
    jsim, tsim = mixed_pair
    cfg = tsim.cfg
    R, LPI, G = min(cfg.SKC, cfg.SK), cfg.LPI, cfg.G
    sq = lambda x: x[..., 0].numpy()
    checked = 0
    for t in (60, 120, 199):
        st, _, mid, _ = jax_mixed_run[t]
        occ = np.arange(st["l_tpl"].shape[0])[:, None] < st["n_l"][None]
        assert len(np.unique(st["l_tpl"][occ])) > 1
        tst = ring_state_from_numpy(st, "cpu")
        _, dbg = ring.ring_step(tsim.tables, cfg, tst, tsim.q, debug=True)
        af, _, ffo = dbg["k2_link"]
        assert_close("K2 any_fail", mid["k_fail"][:R],
                     sq(af).reshape(R, LPI, G))
        assert_close("K2 ff_foe", mid["k_fffoe"][:R],
                     sq(ffo).reshape(R, LPI, G))
        assert_close("K2 ap_ffo", mid["ap_ffo"], sq(dbg["k2_ap"][2]))
        ns, dd = dbg["k3_link"]
        assert_close("K3 link speed", mid["ns_k3"], sq(ns))
        kdis = st["k_dis"].astype(np.float32).reshape(mid["nd_k3"].shape)
        assert_close("K3 link dis", mid["nd_k3"], kdis + sq(dd))
        assert_close("K3 approach speed", mid["ap_spd"], sq(dbg["k3_ap"][0]))
        assert_close("K3 lane speed", mid["new_spd_l"], sq(dbg["k3_lane"][0]))
        checked += int(mid["k_fail"].sum()) + int(st["n_l"].sum())
    assert checked > 0


def test_car_follow_template_mode_equals_uniform_per_template(mixed_pair):
    """K3's template mode with every element on template k equals the
    uniform mode with template k's row as its scalar parameters, bitwise,
    in modes 1, 2 (plain and raw with v_yield) and 3; with mixed leaders
    the no-collision terms take the leader's decelerations."""
    _, tsim = mixed_pair
    table = tsim.tables["tpl_params"]
    gen = torch.Generator().manual_seed(0)
    shape = (3, 5, 4)
    r = lambda lo, hi: lo + (hi - lo) * torch.rand(shape, generator=gen)
    b = lambda p: torch.rand(shape, generator=gen) < p
    inp = dict(speed=r(0, 20), dls=r(-30, 60), isr_lane_left=r(-5, 80),
               any_fail=b(0.4), ff_d=r(0, 90), app=b(0.5), avail=b(0.6),
               can_enter=b(0.6), turn=b(0.3), gap=r(-5, 100),
               lead_spd=r(0, 20), has_lead=b(0.8), v_isr=r(0, 20),
               isr_rel=b(0.5), custom=r(0, 20), has_custom=b(0.1),
               drv_maxspd=r(10, 30), invalid=b(0.1), lane_left=r(-2, 300))
    isr = ("speed", "dls", "isr_lane_left", "any_fail", "ff_d", "app",
           "avail", "can_enter", "turn")
    mc = ("speed", "gap", "lead_spd", "has_lead", "isr_rel", "custom",
          "has_custom", "drv_maxspd", "invalid", "lane_left")
    for k in range(table.shape[0]):
        prm = tuple(float(table[k, c]) for c in car_follow.TPL_COLS) + (1.0,)
        tk = torch.full(shape, k, dtype=torch.int32)
        for mode, names, kw in ((1, isr, {}), (2, mc + ("v_isr",), {}),
                                (3, isr + mc, {}),
                                (2, mc + ("v_isr",), dict(raw=True))):
            a = {n: inp[n] for n in names}
            if kw:
                a["v_yield"] = r(0, 20)
            want = car_follow.car_follow(mode, prm, shape, **kw, **a)
            got = car_follow.car_follow(mode, (float("nan"),) * 9 + (1.0,),
                                        shape, tpl=tk, lead_tpl=tk,
                                        table=table, **kw, **a)
            for w, g in zip(want if isinstance(want, tuple) else (want,),
                            got if isinstance(got, tuple) else (got,)):
                assert torch.equal(w, g), (k, mode)
    # mixed leaders: v_hard / v_soft take the leader's decelerations
    tpl = torch.randint(0, 3, shape, generator=gen, dtype=torch.int32)
    lead = torch.randint(0, 3, shape, generator=gen, dtype=torch.int32)
    a = {n: inp[n] for n in mc + ("v_isr",)}
    got, _ = car_follow.car_follow(2, (0.0,) * 9 + (1.0,), shape, tpl=tpl,
                                   lead_tpl=lead, table=table, **a)
    same, _ = car_follow.car_follow(2, (0.0,) * 9 + (1.0,), shape, tpl=tpl,
                                    lead_tpl=tpl, table=table, **a)
    differs = lead != tpl
    assert bool((got[differs] != same[differs]).any())


def test_lc_units_match_jax(lc_pair, jax_lc_run):
    """lc_front_ctx, refresh_gaps and lc_phase (L1 and L2 in their
    template modes, L3 with the tpl channel) from the same state as JAX's,
    at the steps whose lc_phase starts a change or holds shadows."""
    jsim, tsim = lc_pair
    jt, jc = jsim.tables, jsim.cfg
    picked = [t for t, (st, rs1, _, _) in enumerate(jax_lc_run)
              if st["l_sh"].any() or rs1["l_sh"].sum() > st["l_sh"].sum()]
    assert len(picked) >= 3
    started = 0
    to_port = lambda x: torch.as_tensor(np.array(x))[..., None].contiguous()
    for t in picked[:6]:
        st = jax_lc_run[t][0]
        jst = jax_ring.RingState(**{k: jnp.asarray(v) for k, v in st.items()})
        tst = ring_state_from_numpy(st, "cpu").map(lambda x: x[..., None])
        jfx = jax_ring.lc_front_ctx(jt, jc, jst)
        tfx = ring.lc_front_ctx(tsim.tables, tsim.cfg, tst,
                                ring._Ctx(tsim.tables, tsim.cfg,
                                          torch.device("cpu")))
        assert set(jfx) == set(tfx) and {"etl", "olt_len", "k_etl"} <= \
            set(tfx)
        for k, v in jfx.items():
            assert_close(f"step {t} fx {k}", v, tfx[k][..., 0].numpy())
        port_fx = {k: to_port(v).to(tfx[k].dtype) for k, v in jfx.items()}
        jrs = jax_lc.refresh_gaps(jt, jc, jst, jfx)
        trs = ring_lc.refresh_gaps(tsim.tables, tsim.cfg, tst, port_fx)
        for k in ("l_gap", "k_gap"):
            assert_close(f"step {t} refresh {k}", getattr(jrs, k),
                         getattr(trs, k)[..., 0].numpy())
        jout, jov = jax_lc.lc_phase(jt, jc, jrs, jfx)
        tout, tov = ring_lc.lc_phase(tsim.tables, tsim.cfg, trs, port_fx)
        assert int(np.asarray(jov)) == int(tov[0])
        for k, v in jax_leaves(jout).items():
            assert_close(f"step {t} lc_phase {k}", v,
                         getattr(tout, k)[..., 0].numpy())
        started += int(np.asarray(jout.l_chg).sum()
                       > np.asarray(jrs.l_chg).sum())
    assert started >= 1, "no picked step starts a change"


# ---------------------------------------------------------------------------
# free trajectories and batching
# ---------------------------------------------------------------------------

def test_trajectory_matches_jax(case):
    """Free-running steps of the port against JAX's (tests/test_ring.py
    _run_compare sense): at every tenth step the same vehicles on the same
    drivables, |dis| and |speed| within 2e-3, the same template per
    vehicle; no overflow; the same finished count."""
    (_, tsim), run = case
    tst = tsim.state
    worst = 0.0
    for i in range(1, len(run) + 1):
        tst = ring.ring_step(tsim.tables, tsim.cfg, tst, tsim.q)
        if i % 10:
            continue
        want = run[i - 1][3]
        got = port_leaves(tst)
        a, b = vehicles(want), vehicles(got)
        assert set(a) == set(b), (
            f"step {i}: missing {sorted(set(a) - set(b))[:5]} "
            f"extra {sorted(set(b) - set(a))[:5]}")
        for u in a:
            assert a[u][0] == b[u][0], f"step {i}: {u} {a[u]} vs {b[u]}"
            worst = max(worst, abs(a[u][1] - b[u][1]),
                        abs(a[u][2] - b[u][2]))
        assert worst <= 2e-3, f"step {i}: worst drift {worst}"
        for pre in ("l", "k"):
            n = want[f"n_{pre}"]
            occ = np.arange(want[f"{pre}_tpl"].shape[0])[:, None] < n[None]
            np.testing.assert_array_equal(got[f"{pre}_tpl"][occ],
                                          want[f"{pre}_tpl"][occ])
        assert int(tst.overflow) == 0 == int(want["overflow"])
    assert int(tst.finished_cnt) == int(run[-1][3]["finished_cnt"]) > 0


@pytest.mark.parametrize("config, kw", [(MIXED, MIXED_KW),
                                        (MIXED_LC, MIXED_LC_KW)])
def test_batched_equals_single_env_bitwise(config, kw):
    """B=3 against one env, 60 steps; the single-env run alternates
    ring_step and ring_step_split, the batched one the fused and the
    two-phase entries."""
    steps, B = 60, 3
    tsim = ring_sim.build_sim(compile_scenario(config), horizon=steps + 8,
                              device="cpu", **kw)
    st = tsim.state
    for i in range(steps):
        step = ring.ring_step_split if i % 2 else ring.ring_step
        st = step(tsim.tables, tsim.cfg, st, tsim.q)
    bst = ring.batch_ring_state(tsim.state, B)
    for i in range(steps):
        if i % 2:
            bst = ring.ring_step_batched(tsim.tables, tsim.cfg, bst, tsim.q)
        else:
            bst, mid = ring.ring_step_p1_batched(tsim.tables, tsim.cfg, bst,
                                                 tsim.q)
            bst = ring.ring_step_p2_batched(tsim.tables, tsim.cfg, bst, mid)
    want, got = port_leaves(st), port_leaves(bst)
    assert set(want) == set(got) and "l_tpl" in want
    for k, v in want.items():
        for b in range(B):
            assert np.array_equal(got[k][..., b], v), f"{k} env {b}"
    assert int(st.n_l.sum() + st.n_k.sum()) > 10


def test_nan_poisoned_params_reach_no_output():
    """The scalar parameters are NaN on the non-uniform path; after 60
    steps of each fixture no float leaf and no mid entry holds a NaN, and
    every occupied slot's distance and speed is finite."""
    for config, kw in ((MIXED, MIXED_KW), (MIXED_LC, MIXED_LC_KW)):
        tsim = ring_sim.build_sim(compile_scenario(config), horizon=68,
                                  device="cpu", **kw)
        assert all(np.isnan(tsim.cfg.params))
        st = tsim.state
        for _ in range(60):
            rs1, mid = ring.ring_step_p1(tsim.tables, tsim.cfg, st, tsim.q)
            for k, v in mid.items():
                if v.dtype.is_floating_point:
                    assert not bool(torch.isnan(v).any()), f"mid {k}"
            st = ring.ring_step_p2(tsim.tables, tsim.cfg, rs1, mid)
            for k, v in st.leaves().items():
                if v.dtype.is_floating_point:
                    assert not bool(torch.isnan(v).any()), k
        assert int(st.n_l.sum()) > 0 and int(st.overflow) == 0


def test_ring_vec_env_matches_jax_on_mixed_templates():
    """RingVecEnv on config_2x2_mixed.json at B=2 against JAX's, each
    under its own MaxPressure actions every 5 steps for 30 steps: equal
    observations (avg_travel_time within 1e-5 relative) and rewards while
    the waiting counts agree, equal actions at every decision taken on
    equal waiting."""
    steps, B = 30, 2
    je = JaxRingVecEnv(MIXED, batch=B, horizon=steps + 8)
    te = RingVecEnv(MIXED, batch=B, horizon=steps + 8, device="cpu")
    assert not te.sim.cfg.uniform
    je.reset()
    te.reset()
    I = te.num_intersections
    ja = np.zeros((B, I), np.int32)
    ta = torch.zeros((B, I), dtype=torch.int32)
    prev_same, decisions = True, 0
    for t in range(steps):
        if t % 5 == 0 and t:
            ja = np.asarray(je.max_pressure_actions())
            ta = te.max_pressure_actions()
            if prev_same:
                decisions += 1
                np.testing.assert_array_equal(ta.numpy(), ja)
        jo, jr = je.step(jnp.asarray(ja))
        to, tr = te.step(ta)
        for k in ("lane_count", "vehicle_count", "current_time"):
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]),
                                          err_msg=f"{k} step {t}")
        np.testing.assert_allclose(to["avg_travel_time"].numpy(),
                                   np.asarray(jo["avg_travel_time"]),
                                   rtol=1e-5)
        prev_same = np.array_equal(to["lane_waiting"].numpy(),
                                   np.asarray(jo["lane_waiting"]))
        if prev_same:
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert decisions >= 4
    assert int(te.state.n_l.sum()) > 0


def test_non_finite_template_parameters_are_refused(tmp_path):
    """JAX's one-hot einsum gives NaN for an infinite parameter where a
    gather would not: build_sim refuses such templates."""
    import json
    with open(MIXED) as f:
        cfgj = json.load(f)
    with open(os.path.join(FIX, cfgj["flowFile"])) as f:
        flows = json.load(f)
    flows[1]["vehicle"] = dict(flows[1]["vehicle"], headwayTime=float("inf"))
    (tmp_path / "flow.json").write_text(json.dumps(flows))
    cfgj.update(dir=FIX + "/", flowFile=str(tmp_path / "flow.json"))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfgj))
    with pytest.raises(ValueError, match="finite"):
        ring_sim.build_sim(compile_scenario(str(path)), horizon=8,
                           device="cpu")


@pytest.mark.parametrize("templates", [False, True],
                         ids=["uniform", "template"])
def test_stopped_at_the_lane_end_keeps_the_reference_min(templates):
    """A vehicle stopped (speed 0) with no distance left before a red
    light: getStopBeforeSpeed is 0 - 0 / 0 = NaN. The reference's
    std::min(v, NaN) keeps v; JAX's jnp.minimum returns the NaN, which
    then runs into the speeds and distances (the mixed 30x30 lane-change
    grid meets it). K3 keeps the reference's rule in its uniform and its
    template instantiation alike, so the uniform path departs from JAX
    here too."""
    from cityflow_tpu.core.step import stop_before_speed as jax_sbs
    f = np.float32
    nan = jnp.minimum(f(16.67), jax_sbs(f(0.0), f(2.0), f(4.5), f(0.0),
                                        f(1.0)))
    assert np.isnan(np.asarray(nan))
    shape = (2,)
    prm = (16.67, 8.0, 2.0, 4.5, 5.0, 4.5, 2.5, 1.5, 2.0, 1.0)
    t = lambda *v: torch.tensor(v, dtype=torch.float32)
    inp = dict(speed=t(0.0, 0.0), dls=t(-1.0, -1.0),
               isr_lane_left=t(0.0, 3.0), any_fail=torch.tensor([True, False]),
               ff_d=t(4.0, 9.0), app=True, avail=False, can_enter=True,
               turn=False)
    if templates:
        table = torch.zeros((1, 12))
        for c, v in zip(car_follow.TPL_COLS, prm):
            table[0, c] = v
        v, red = car_follow.car_follow(
            1, (float("nan"),) * 9 + (1.0,), shape,
            tpl=torch.zeros(shape, dtype=torch.int32), table=table, **inp)
    else:
        v, red = car_follow.car_follow(1, prm, shape, **inp)
    assert bool(red.all()) and bool(torch.isfinite(v).all())
    # the first: both stop-before speeds are NaN, v keeps maxSpeed; the
    # second: 3 m left, the usual stop-before speed
    assert float(v[0]) == f(16.67) and float(v[1]) < 16.67
