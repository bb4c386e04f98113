"""Ring lane change in the PyTorch port (cityflow_tpu_torch.core.ring_lc and
the lane-change branches of core/ring.py) against the JAX package's, on the
CPU, where every kernel wrapper runs its plain PyTorch version.

The dense 1x1s fixture runs as tests/test_ring_lc.py runs it (sl=12, sk=6,
skc=99): changes fire within the first steps there. JAX's 80 steps are run
once, phase by phase, in a module fixture; the per-phase, unit and
trajectory tests all read it. Integer and bool values must be equal,
float32 ones within 1e-5 (per phase) or 2e-3 (free trajectories).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cityflow_tpu import ring_sim as jax_ring_sim
from cityflow_tpu.compiler.net import compile_scenario as jax_compile
from cityflow_tpu.core import ring as jax_ring
from cityflow_tpu.core import ring_lc as jax_lc

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.carry import mid_from_numpy, ring_state_from_numpy
from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.core import ring, ring_lc
from test_torch_ring import assert_close, jax_leaves, port_leaves, vehicles

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
LC1 = os.path.join(FIX, "config_1x1s_lc.json")
LC1_KW = dict(sl=12, sk=6, skc=99)
STEPS = 80


def _pair(config, steps, **kw):
    jsim = jax_ring_sim.build_sim(jax_compile(config), horizon=steps + 8,
                                  **kw)
    tsim = ring_sim.build_sim(compile_scenario(config), horizon=steps + 8,
                              device="cpu", **kw)
    return jsim, tsim


@pytest.fixture(scope="module")
def lc_pair():
    return _pair(LC1, STEPS, **LC1_KW)


@pytest.fixture(scope="module")
def jax_lc_run(lc_pair):
    """JAX's 80 steps phase by phase, as numpy leaves: for each step the
    state it starts from, p1's (rs, mid) and p2's state."""
    jsim, _ = lc_pair
    run, st = [], jsim.state
    for _ in range(STEPS):
        rs1, mid = jax_ring.ring_step_p1(jsim.tables, jsim.cfg, st, jsim.q)
        st2 = jax_ring.ring_step_p2(jsim.tables, jsim.cfg, rs1, mid)
        run.append((jax_leaves(st), jax_leaves(rs1),
                    {k: np.asarray(v) for k, v in mid.items()}, st2))
        st = st2
    return [(a, b, c, jax_leaves(d)) for a, b, c, d in run], st


# ---------------------------------------------------------------------------
# index tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", ["config_1x1s_lc.json",
                                    "config_2x2_lc.json", "config_4x4.json"])
def test_neighbour_indices_match_jax_perm(config):
    """inner_src / outer_src reproduce ring_lc._perm (the TPU shift plan)
    exactly: row p of _perm's output is lane src[p], 0 where src[p] = -1."""
    path = os.path.join(FIX, config)
    jsim = jax_ring_sim.build_sim(jax_compile(path), horizon=8)
    from cityflow_tpu_torch.compiler.ring_net import build_ring
    net = compile_scenario(path)
    tb, _ = build_ring(net, float(net.host.config["interval"]))
    LNp = jsim.cfg.LNp
    rows = jnp.arange(1, LNp + 1, dtype=jnp.float32)[:, None]
    for which in ("inner", "outer"):
        out, valid = jax_lc._perm(jsim.tables, jsim.cfg, rows, which)
        want = np.where(np.asarray(valid), np.asarray(out)[:, 0] - 1, -1)
        got = np.asarray(tb[f"{which}_src"])
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want.astype(np.int64),
                                      err_msg=f"{config} {which}")
    assert (np.asarray(tb["inner_src"]) >= 0).any()


def test_neighbour_index_disagreeing_with_the_shift_plan_is_refused():
    from cityflow_tpu_torch.compiler.ring_net import build_ring, index_tables
    net = compile_scenario(LC1)
    tb, meta = build_ring(net, float(net.host.config["interval"]))
    bad = dict(tb)
    inner = np.asarray(tb["ln_inner"]).copy()
    p = int(np.nonzero(inner >= 0)[0][0])
    inner[p] = (inner[p] + 1) % len(inner)
    bad["ln_inner"] = inner
    with pytest.raises(ValueError, match="shift plan disagrees"):
        index_tables(bad, meta.type_ranges, meta.G, meta.I,
                     lane_shifts=(meta.inn_shifts, meta.out_shifts))


# ---------------------------------------------------------------------------
# per phase and per unit, from JAX's state
# ---------------------------------------------------------------------------

def test_lc_per_phase_matches_jax(lc_pair, jax_lc_run):
    """Both phases of all 80 steps, each from JAX's state; lane-change
    leaves and mid entries included. At least three steps start with
    shadows on the rings."""
    _, tsim = lc_pair
    run, _ = jax_lc_run
    with_shadows = 0
    for t, (st, rs1, mid, st2) in enumerate(run):
        with_shadows += bool(st["l_sh"].any())
        trs1, tmid = ring.ring_step_p1(
            tsim.tables, tsim.cfg, ring_state_from_numpy(st, "cpu"), tsim.q)
        for k, v in rs1.items():
            assert_close(f"step {t} p1 {k}", v, getattr(trs1, k).numpy())
        assert set(mid) == set(tmid)
        for k, v in mid.items():
            assert_close(f"step {t} mid {k}", v, tmid[k].numpy())
        tst2 = ring.ring_step_p2(
            tsim.tables, tsim.cfg, ring_state_from_numpy(rs1, "cpu"),
            mid_from_numpy(mid, "cpu"))
        for k, v in st2.items():
            assert_close(f"step {t} p2 {k}", v, getattr(tst2, k).numpy())
        for k in ring.LC_FIELDS:
            assert k in st2 and getattr(tst2, k) is not None
    assert with_shadows >= 3, with_shadows


def _to_port(x):
    a = np.array(x)
    dt = torch.bool if a.dtype == np.bool_ else (
        torch.int32 if np.issubdtype(a.dtype, np.integer) else torch.float32)
    return torch.as_tensor(a).to(dt)[..., None].contiguous()


def test_lc_units_match_jax(lc_pair, jax_lc_run):
    """lc_front_ctx, refresh_gaps, lc_phase (L1 -> L2 -> L3) and
    partner_fetch (L4) from the same state as JAX's, at the steps whose
    state holds shadows or whose lc_phase starts a change."""
    jsim, tsim = lc_pair
    run, _ = jax_lc_run
    jt, jc = jsim.tables, jsim.cfg
    picked = [t for t, (st, rs1, _, _) in enumerate(run)
              if st["l_sh"].any() or rs1["l_sh"].sum() > st["l_sh"].sum()]
    assert len(picked) >= 3
    started = 0
    for t in picked[:6]:
        st = run[t][0]
        jst = jax_ring.RingState(**{k: jnp.asarray(v) for k, v in st.items()})
        tst = ring_state_from_numpy(st, "cpu").map(lambda x: x[..., None])
        jfx = jax_ring.lc_front_ctx(jt, jc, jst)
        tfx = ring.lc_front_ctx(tsim.tables, tsim.cfg, tst,
                                ring._Ctx(tsim.tables, tsim.cfg,
                                          torch.device("cpu")))
        assert set(jfx) == set(tfx)
        for k, v in jfx.items():
            assert_close(f"step {t} fx {k}", v, tfx[k][..., 0].numpy())
        jrs = jax_lc.refresh_gaps(jt, jc, jst, jfx)
        trs = ring_lc.refresh_gaps(tsim.tables, tsim.cfg, tst,
                                   {k: _to_port(v) for k, v in jfx.items()})
        for k in ("l_gap", "k_gap"):
            assert_close(f"step {t} refresh {k}", getattr(jrs, k),
                         getattr(trs, k)[..., 0].numpy())
        jout, jov = jax_lc.lc_phase(jt, jc, jrs, jfx)
        tout, tov = ring_lc.lc_phase(tsim.tables, tsim.cfg, trs,
                                     {k: _to_port(v) for k, v in jfx.items()})
        assert int(np.asarray(jov)) == int(tov[0])
        for k, v in jax_leaves(jout).items():
            assert_close(f"step {t} lc_phase {k}", v,
                         getattr(tout, k)[..., 0].numpy())
        started += int(np.asarray(jout.l_chg).sum()
                       > np.asarray(jrs.l_chg).sum())
        chans = [jout.l_speed, jout.l_dis, jout.l_off]
        (jv, jf) = jax_lc.partner_fetch(jt, jc, jout, chans)
        tv, tf = ring_lc.partner_fetch(
            tsim.tables, tout, [getattr(tout, k) for k in
                                ("l_speed", "l_dis", "l_off")])
        assert_close(f"step {t} partner found", jf, tf[..., 0].numpy())
        for i, (a, b) in enumerate(zip(jv, tv)):
            assert_close(f"step {t} partner ch{i}", a, b[..., 0].numpy())
        assert np.asarray(jf).any() or not np.asarray(jout.l_sh).any()
    assert started >= 1, "no picked step starts a change"


# ---------------------------------------------------------------------------
# free trajectories
# ---------------------------------------------------------------------------

def test_lc_trajectory_matches_jax(lc_pair, jax_lc_run):
    """80 free-running steps of the port against JAX's: at every tenth
    step the same (uid, shadow) vehicles on the same drivables, |dis| and
    |speed| within 2e-3, equal (changing, shadow) counts; no overflow;
    the same finished count; changes happen."""
    _, tsim = lc_pair
    run, _ = jax_lc_run
    tst = tsim.state
    worst, changes = 0.0, 0
    for i in range(1, STEPS + 1):
        tst = ring.ring_step(tsim.tables, tsim.cfg, tst, tsim.q)
        changes += int(tst.l_chg.sum())
        if i % 10:
            continue
        want = run[i - 1][3]
        a, b = vehicles(want), vehicles(port_leaves(tst))
        assert set(a) == set(b), (
            f"step {i}: missing {sorted(set(a) - set(b))} "
            f"extra {sorted(set(b) - set(a))}")
        for u in a:
            assert a[u][0] == b[u][0], f"step {i}: {u} {a[u]} vs {b[u]}"
            worst = max(worst, abs(a[u][1] - b[u][1]),
                        abs(a[u][2] - b[u][2]))
        assert worst <= 2e-3, f"step {i}: worst drift {worst}"
        assert (int(want["l_chg"].sum()), int(want["l_sh"].sum())) == \
            (int(tst.l_chg.sum()), int(tst.l_sh.sum())), f"step {i}"
        assert int(tst.overflow) == 0 == int(want["overflow"])
    assert changes > 0, "the scenario triggered no lane change"
    assert int(tst.finished_cnt) == int(run[-1][3]["finished_cnt"])


@pytest.mark.slow
def test_lc_trajectory_matches_jax_2x2():
    """The 2x2 grid's 300 m roads: changes fire late (JAX's own 2x2 test
    notes it), so 120 steps."""
    jsim, tsim = _pair(os.path.join(FIX, "config_2x2_lc.json"), 120,
                       skc=None)
    jst, tst = jsim.state, tsim.state
    changes = 0
    for i in range(1, 121):
        jst = jax_ring.ring_step(jsim.tables, jsim.cfg, jst, jsim.q)
        tst = ring.ring_step(tsim.tables, tsim.cfg, tst, tsim.q)
        changes += int(tst.l_chg.sum())
        if i % 10:
            continue
        a, b = vehicles(jax_leaves(jst)), vehicles(port_leaves(tst))
        assert set(a) == set(b), f"step {i}"
        for u in a:
            assert a[u][0] == b[u][0]
            assert abs(a[u][1] - b[u][1]) <= 2e-3
            assert abs(a[u][2] - b[u][2]) <= 2e-3
        assert int(np.asarray(jst.l_sh).sum()) == int(tst.l_sh.sum())
    assert changes > 0
    assert int(tst.overflow) == 0


def test_lc_batched_equals_single_env_bitwise():
    """Batched B=3 against one env on 1x1s, 60 steps; the single-env run
    alternates ring_step and ring_step_split."""
    steps, B = 60, 3
    tsim = ring_sim.build_sim(compile_scenario(LC1), horizon=steps + 8,
                              device="cpu", **LC1_KW)
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
    assert set(want) == set(got) and "l_sh" in want
    for k, v in want.items():
        for b in range(B):
            assert np.array_equal(got[k][..., b], v), f"{k} env {b}"
    assert int(st.n_l.sum() + st.n_k.sum()) > 10


# ---------------------------------------------------------------------------
# what is still refused, and lane change off
# ---------------------------------------------------------------------------

def test_lc_with_mixed_templates_or_duration_is_refused(tmp_path):
    """Mixed templates with lane change are still refused; lane change
    with the DURATION router is not any more: it builds with the history
    window on (tests/test_torch_history.py holds it against JAX)."""
    net = compile_scenario(os.path.join(FIX, "config_1x1s_mixed_lc.json"))
    with pytest.raises(NotImplementedError,
                       match="lane change with non-uniform"):
        ring_sim.build_sim(net, horizon=8, device="cpu")
    with open(LC1) as f:
        cfgj = json.load(f)
    for k in ("roadnetFile", "flowFile"):
        shutil.copy(os.path.join(FIX, cfgj[k]), tmp_path / cfgj[k])
    cfgj.update(dir=str(tmp_path) + "/", routerType="DURATION")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfgj))
    sim = ring_sim.build_sim(compile_scenario(str(path)), horizon=8,
                             device="cpu", **LC1_KW)
    assert sim.cfg.lane_change and sim.cfg.track_history
    assert sim.state.h_ring_num.shape == (sim.cfg.history_len + 1,
                                          sim.cfg.LNp)


def test_lc_leaves_absent_when_lane_change_is_off():
    """The counterpart of test_ring_lc_noop_when_disabled: with lane change
    off nothing of it is allocated."""
    tsim = ring_sim.build_sim(compile_scenario(
        os.path.join(FIX, "config_4x4.json")), horizon=24, device="cpu")
    assert not tsim.cfg.lane_change
    st = tsim.state
    for _ in range(12):
        st = ring.ring_step(tsim.tables, tsim.cfg, st, tsim.q)
    for k in ring.LC_FIELDS:
        assert getattr(st, k) is None, k
        assert k not in st.leaves()
    assert int(st.overflow) == 0


def test_bench_single_env_warmup_equals_batched_steps():
    """tools/bench.run_ring warms up one env and copies it into the batch;
    the timed steps then start from the state a batched run reaches, and
    on_step sees each of them."""
    from cityflow_tpu_torch.tools import bench
    args = bench.parser().parse_args(
        ["--config", LC1, "--batch", "2", "--warmup", "30", "--window", "0",
         "--steps", "4", "--lane-slots", "12"])
    net = compile_scenario(LC1)
    seen = []
    r = bench.run_ring(args, net, 2, torch.device("cpu"),
                       on_step=lambda s: seen.append(int(s.step[0])))
    assert r["steps_run"] == 34 and seen == [31, 32, 33, 34]
    tsim = ring_sim.build_sim(net, horizon=40, sl=12, device="cpu")
    st = ring.batch_ring_state(tsim.state, 2)
    for _ in range(34):
        st = ring.ring_step_batched(tsim.tables, tsim.cfg, st, tsim.q)
    want, got = port_leaves(st), port_leaves(r["state"])
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
