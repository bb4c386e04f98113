"""gen-1 fast mode (float32) of the port against the JAX package's:
G2's fast branch (the per-drivable candidate table), G9 blocker_cycles
and G10 update_location in both modes, all through their plain versions
(this host has no card), and the fast `Engine` against JAX's per step;
fast mode tracks exact mode as tests/test_batching.py::
test_fast_tracks_exact has it (that test's fixture is absent here, so it
is restated on config_4x4.json)."""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cityflow_tpu.core import state as jstate
from cityflow_tpu.core import step as js
from cityflow_tpu.engine import Engine as JEngine
from cityflow_tpu.engine import _net_device_arrays

from cityflow_tpu_torch.carry import sim_state_from_numpy, sim_state_to_numpy
from cityflow_tpu_torch.core import step as ts
from cityflow_tpu_torch.core.state import SIM_FIELDS, StepConfig
from cityflow_tpu_torch.engine import Engine
from cityflow_tpu_torch.kernels.blocker_cycles import (
    blocker_cycles_plain, walk_steps)

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
ENGINE_STEPS = 100
SCAN_STEPS = (30, 60)
F32_TOL = 1e-5


def _leaves(st):
    return {k: np.asarray(getattr(st, k)) for k in SIM_FIELDS}


def _jstate(leaves):
    return jstate.SimState(**{k: jnp.asarray(v) for k, v in leaves.items()})


def _mismatches(mine, theirs, tol):
    """Leaves that differ: ints and bools exactly, floats beyond `tol`
    relative to the larger of 1 and the leaf's largest magnitude."""
    bad = []
    for k in SIM_FIELDS:
        a, b = np.asarray(mine[k]), np.asarray(theirs[k])
        if a.shape != b.shape:
            bad.append((k, "shape"))
        elif a.dtype.kind == "f":
            both_nan = np.isnan(a) & np.isnan(b)
            d = np.where(both_nan, 0.0, np.abs(a.astype(np.float64)
                                               - b.astype(np.float64)))
            scale = max(1.0, float(np.nanmax(np.abs(b))) if b.size else 1.0)
            if d.size and not (d <= tol * scale).all():
                bad.append((k, float(np.nanmax(d))))
        elif not np.array_equal(a.astype(np.int64), b.astype(np.int64)):
            bad.append((k, int((a.astype(np.int64)
                                != b.astype(np.int64)).sum())))
    return bad


@pytest.fixture(scope="module")
def fast_4x4():
    """JAX's and the port's gen-1 fast Engines on config_4x4.json, step
    by step: every step's differing leaves, JAX's states at SCAN_STEPS,
    and the port's (config, net)."""
    path = os.path.join(FIX, "config_4x4.json")
    j = JEngine(path, exact=False, backend="gen1")
    p = Engine(path, exact=False, backend="gen1", device="cpu")
    bad, states = {}, {}
    for t in range(1, ENGINE_STEPS + 1):
        j.next_step()
        p.next_step()
        jl = _leaves(j.state)
        bad[t] = _mismatches(sim_state_to_numpy(p.state), jl, F32_TOL)
        if t in SCAN_STEPS:
            states[t] = jl
    return dict(bad=bad, states=states, eng=p, jnet=j._net_dev,
                jcfg=j.cfg, vehicles=p.get_vehicle_count())


def test_engine_fast_matches_jax_per_step(fast_4x4):
    """Engine(exact=False, backend="gen1") on the CPU against JAX's for
    100 steps: every SimState leaf, ints and bools exact, floats within
    1e-5 (both divide by the interval, 1.0 here, so XLA's reciprocal
    rewrite changes nothing)."""
    assert fast_4x4["eng"].state.dis.dtype == torch.float32
    assert fast_4x4["vehicles"] > 400
    bad = {t: b for t, b in fast_4x4["bad"].items() if b}
    assert not bad, f"first differing step {min(bad)}: {bad[min(bad)]}"


@partial(jax.jit, static_argnums=(1,))
def _jax_scan(net, cfg, st):
    cyc = js.blocker_cycles(cfg, st.blocker)
    fattrs, iattrs = js.build_attr_packs(cfg, st, cyc)
    arr = js.arrangement(net, cfg, st.running, st.drv, st.dis, st.list_seq,
                         st.params[:, js.P_LEN], fattrs=fattrs, iattrs=iattrs)
    return js.leader_scan(net, cfg, st, arr, st.running)


@pytest.mark.parametrize("t", SCAN_STEPS)
def test_leader_scan_fast_matches_jax(fast_4x4, t):
    """G2's fast branch on JAX's fast state of config_4x4.json at step t,
    every running vehicle scanning: found exact, gap within 1e-5."""
    leaves = fast_4x4["states"][t]
    eng = fast_4x4["eng"]
    jf, jg = _jax_scan(fast_4x4["jnet"], fast_4x4["jcfg"], _jstate(leaves))
    st = ts.lift(sim_state_from_numpy(leaves, "cpu", torch.float32))
    cfg = eng.cfg
    arr = ts.arrangement(eng._net_dev, cfg, st.running, st.drv, st.dis,
                         st.list_seq)
    pf, pg = ts.squeeze(ts.leader_scan(eng._net_dev, cfg, st, arr,
                                       st.running))
    assert pg.dtype == torch.float32
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    assert int((pf >= 0).sum()) > 5
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0,
                               atol=F32_TOL)


def test_leader_scan_fast_is_jax_fast_branch_not_exact(fast_4x4):
    """The fast table reads dis_rem + (dis - len) where the exact branch
    adds left to right: the two may round apart, and the fast plain
    version follows JAX's fast branch, not the exact one."""
    leaves = fast_4x4["states"][SCAN_STEPS[-1]]
    eng = fast_4x4["eng"]
    st = ts.lift(sim_state_from_numpy(leaves, "cpu", torch.float32))
    cfg = eng.cfg
    arr = ts.arrangement(eng._net_dev, cfg, st.running, st.drv, st.dis,
                         st.list_seq)
    fast = ts.leader_scan(eng._net_dev, cfg, st, arr, st.running)
    exact = ts.leader_scan(eng._net_dev, dataclasses.replace(cfg, exact=True),
                           st, arr, st.running)
    np.testing.assert_array_equal(fast[0].numpy(), exact[0].numpy())
    np.testing.assert_allclose(fast[1].numpy(), exact[1].numpy(), rtol=0,
                               atol=F32_TOL)


def _blocker_map(seed, V):
    """A functional graph on V slots: chains longer than 2^6 ending in -1,
    chains into cycles of several lengths, self-loops and free slots."""
    rng = np.random.default_rng(seed)
    b = np.full(V, -1, np.int32)
    perm = rng.permutation(V)
    i = 0
    while i < V - 2:
        n = int(rng.integers(2, min(V - i, 200) + 1))
        seg = perm[i:i + n]
        kind = rng.integers(0, 3)
        b[seg[:-1]] = seg[1:]
        if kind == 1:                       # into a cycle of its tail
            b[seg[-1]] = seg[int(rng.integers(0, n))]
        elif kind == 2:                     # into an earlier chain
            b[seg[-1]] = perm[int(rng.integers(0, i + 1))]
        i += n
    free = rng.random(V) < 0.2
    b[free & (b == np.arange(V))] = -1
    return b


def _walk_reference(blocker, exact, k_chase):
    """The kernel's algorithm in Python: fast mode walks S hops, exact
    mode runs Brent's cycle finder until -1."""
    V = len(blocker)
    S = walk_steps(V, exact, k_chase)
    out = np.zeros(V, bool)
    for v in range(V):
        if exact:
            tortoise, hare, power, lam = v, int(blocker[v]), 1, 1
            while hare >= 0 and hare != tortoise:
                if power == lam:
                    tortoise, power, lam = hare, power * 2, 0
                hare = int(blocker[hare])
                lam += 1
            out[v] = hare >= 0
        else:
            x = v
            for _ in range(S):
                if x < 0:
                    break
                x = int(blocker[x])
            out[v] = x >= 0
    return out


@partial(jax.jit, static_argnums=(0,))
def _jax_cycles(cfg, blocker):
    return js.blocker_cycles(cfg, blocker)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("seed,V,k_chase", [(0, 700, 6), (1, 1500, 6),
                                             (2, 300, 3), (3, 40, 6)])
def test_blocker_cycles_matches_jax(seed, V, k_chase, exact):
    """G9 (plain) against JAX's blocker_cycles, bitwise, on seeded blocker
    maps with chains longer than 2^k_chase, cycles and -1 tails; the
    kernel's walk (Brent's cycle finder in exact mode, S hops in fast
    mode) gives the same flags."""
    b = _blocker_map(seed, V)
    cfg = jstate.StepConfig(interval=1.0, num_lanes=1, num_drivables=1,
                            max_vehicles=V, k_chase=k_chase, exact=exact)
    want = np.asarray(_jax_cycles(cfg, jnp.asarray(b)))
    got = blocker_cycles_plain(torch.as_tensor(b)[None], exact,
                               k_chase)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_walk_reference(b, exact, k_chase), want)
    assert 0 < want.sum() < V
    if not exact and walk_steps(V, True, k_chase) > walk_steps(
            V, False, k_chase):
        # the cap shows: a long chain still alive after S hops
        assert (want != np.asarray(_jax_cycles(
            dataclasses.replace(cfg, exact=True), jnp.asarray(b)))).any()


@partial(jax.jit, static_argnums=(1,))
def _jax_update_location(net, cfg, st, arr, buf):
    return js.update_location(net, cfg, st, arr, buf)


def _ul_inputs(config, exact, steps):
    """The port's engine run to each of `steps`; at each, the state after
    this step's part 1 and the arrangement and buffers of part 2 (the
    inputs update_location gets), as a batch of one."""
    eng = Engine(os.path.join(FIX, config), exact=exact, backend="gen1",
                 device="cpu")
    out = []
    for t in range(1, max(steps) + 1):
        eng.next_step()
        if t in steps:
            st, arr = ts.step_part1(eng._net_dev, eng.cfg,
                                    ts.lift(eng.state), eng._spawn_dev)
            buf, _ = ts.step_part2(eng._net_dev, eng.cfg, st, arr)
            out.append((eng, st, arr, buf))
    return out


UL_CASES = [("config_2x2.json", True, (77, 85, 99)),
            ("config_2x2.json", False, (77, 85, 99)),
            ("config_2x2_lc.json", False, (175, 190, 240))]


@pytest.fixture(scope="module")
def ul_recorded():
    out = {}
    for config, exact, steps in UL_CASES:
        for eng, st, arr, buf in _ul_inputs(config, exact, steps):
            jnet = _net_device_arrays(
                eng.net, np.float64 if exact else np.float32)
            jcfg = jstate.StepConfig(**dataclasses.asdict(eng.cfg))
            pnew, prm = ts.squeeze(ts.update_location(
                eng._net_dev, eng.cfg, st, arr, buf))
            st, arr, buf = ts.squeeze((st, arr, buf))
            jst = _jstate(sim_state_to_numpy(st))
            jbuf = {k: jnp.asarray(v.numpy()) for k, v in buf.items()}
            jarr = dict(sorted_idx=jnp.asarray(arr["sorted_idx"].numpy()))
            jnew, jrm = _jax_update_location(jnet, jcfg, jst, jarr, jbuf)
            out.setdefault((config, exact), []).append(dict(
                jax=(_leaves(jnew), np.asarray(jrm)),
                port=(sim_state_to_numpy(pnew), prm.numpy()),
                moved=int(buf["changed"].sum()),
                finish=int(buf["finish"].sum()) if "finish" in buf else 0))
    return out


@pytest.mark.parametrize("case", UL_CASES,
                         ids=lambda c: f"{c[0][7:-5]}-"
                         f"{'exact' if c[1] else 'fast'}")
def test_update_location_matches_jax(ul_recorded, case):
    """G10 (plain) against JAX's update_location on the inputs of three
    steps each: removals, the finish count and the transfer tickets and
    entry times exact; cum_travel bitwise in exact mode, within 1e-5
    relative in fast mode (the unordered sum); under lane change a
    finishing change is removed and not counted."""
    recs = ul_recorded[case[0], case[1]]
    for r in recs:
        (jl, jrm), (pl, prm) = r["jax"], r["port"]
        np.testing.assert_array_equal(prm, jrm)
        for k in ("list_seq", "enter_ll_time", "finished_cnt",
                  "seq_counter", "overflow"):
            np.testing.assert_array_equal(pl[k].astype(np.int64),
                                          jl[k].astype(np.int64), err_msg=k)
        if case[1]:
            assert pl["cum_travel"] == jl["cum_travel"]
        else:
            np.testing.assert_allclose(pl["cum_travel"], jl["cum_travel"],
                                       rtol=F32_TOL)
    removed = sum(int(r["port"][1].sum()) for r in recs)
    assert removed > 0 and sum(r["moved"] for r in recs) >= 3
    assert sum(int(r["port"][0]["finished_cnt"]) for r in recs) > 0
    if "lc" in case[0]:
        assert sum(r["finish"] for r in recs) > 0


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_update_location_ranks_ties_like_jax(exact):
    """Seeded transfers with equal distances, +0.0 and -0.0 among them:
    the ranks follow JAX's argsort (ties by slot, -0.0 equal to 0.0)."""
    rng = np.random.default_rng(5)
    V = 96
    f = np.float64 if exact else np.float32
    running = rng.random(V) < 0.8
    end = rng.random(V) < 0.15
    changed = rng.random(V) < 0.6
    dis = rng.choice(np.array([0.0, -0.0, 1.5, 2.25, 7.0], f), V)
    drv = rng.integers(0, 12, V).astype(np.int32)
    et = rng.integers(0, 40, V).astype(f)
    order = np.arange(V, dtype=np.int32)
    rng.shuffle(order)
    scal = dict(step=np.int32(50), seq_counter=np.int32(1000),
                finished_cnt=np.int32(3), cum_travel=f(11.5),
                overflow=np.int32(0))
    cfg = StepConfig(interval=1.0, num_lanes=6, num_drivables=12,
                     max_vehicles=V, max_remove=4, exact=exact)
    leaves = {k: np.zeros(V, np.int32) for k in SIM_FIELDS}
    st = sim_state_from_numpy({**leaves, **scal, "running": running,
                               "enter_time": et,
                               "list_seq": np.arange(V, dtype=np.int32),
                               "enter_ll_time": np.full(V, 7, np.int32),
                               "params": np.zeros((V, 12)),
                               "phase": np.zeros(1), "phase_remain":
                               np.zeros(1), "last_of_drv": np.zeros(12),
                               "hist_ring_num": np.zeros((1, 1)),
                               "hist_ring_ssum": np.zeros((1, 1)),
                               "hist_num": np.zeros(1),
                               "hist_ssum": np.zeros(1)},
                              "cpu", torch.float64 if exact else torch.float32)
    buf = dict(end=torch.as_tensor(end), changed=torch.as_tensor(changed),
               dis=torch.as_tensor(dis), drv=torch.as_tensor(drv))
    arr = dict(sorted_idx=torch.as_tensor(order))
    net = dict(interval=torch.tensor(1.0, dtype=st.dis.dtype))
    pnew, prm = ts.squeeze(ts.update_location(net, cfg, ts.lift(st),
                                              ts.lift(arr), ts.lift(buf)))
    jnet = dict(interval=jnp.asarray(f(1.0)))
    jnew, jrm = _jax_update_location(
        jnet, jstate.StepConfig(**dataclasses.asdict(cfg)),
        _jstate(sim_state_to_numpy(st)),
        dict(sorted_idx=jnp.asarray(order)),
        {k: jnp.asarray(v.numpy()) for k, v in buf.items()})
    np.testing.assert_array_equal(prm.numpy(), np.asarray(jrm))
    for k in ("list_seq", "enter_ll_time", "seq_counter", "finished_cnt",
              "overflow"):
        np.testing.assert_array_equal(
            getattr(pnew, k).numpy().astype(np.int64),
            np.asarray(getattr(jnew, k)).astype(np.int64), err_msg=k)
    np.testing.assert_allclose(float(pnew.cum_travel), float(jnew.cum_travel),
                               rtol=0 if exact else F32_TOL)
    if exact:
        assert int(pnew.overflow) & 8      # 4 slots summed, more counted


def test_fast_tracks_exact():
    """tests/test_batching.py::test_fast_tracks_exact on config_4x4.json:
    after 40 steps the fast Engine runs the same vehicles (> 98% of the
    slots agree) at positions within float32 drift (median under 0.5)."""
    path = os.path.join(FIX, "config_4x4.json")
    e = Engine(path, device="cpu")
    f = Engine(path, exact=False, backend="gen1", device="cpu")
    for _ in range(40):
        e.next_step()
        f.next_step()
    run_e, run_f = e.state.running.numpy(), f.state.running.numpy()
    assert run_e.sum() > 100
    assert (run_e == run_f).mean() > 0.98
    both = run_e & run_f
    d = np.abs(e.state.dis.numpy()[both] - f.state.dis.numpy()[both])
    assert np.median(d) < 0.5
