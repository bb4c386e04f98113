"""The batched gen-1 step of the PyTorch port (core/step.py with a leading
env axis, parallel/batch.py, G11 spawn_slots and G12 admit_heads) against
its own single-env step and against the JAX package's vmapped step, on the
CPU, where every kernel wrapper takes its plain version.

tests/test_batching.py holds the JAX package's batching to the same rules
on config_example.json, which is absent here; these tests restate them on
config_4x4.json (fast mode) and config_2x2.json (exact mode): B envs with
their own phases step as B single envs do, bit for bit; the split step
equals the monolithic one; a rollout equals its steps.
"""

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
from cityflow_tpu.engine import _net_device_arrays
from cityflow_tpu.parallel import batch as jbatch

from cityflow_tpu_torch.carry import sim_state_from_numpy, sim_state_to_numpy
from cityflow_tpu_torch.core import step as ts
from cityflow_tpu_torch.core.state import SIM_FIELDS, init_state
from cityflow_tpu_torch.engine import Engine
from cityflow_tpu_torch.kernels.admit_heads import admit_heads_plain
from cityflow_tpu_torch.kernels.spawn_slots import spawn_slots_plain
from cityflow_tpu_torch.parallel.batch import (
    init_batch_state, make_batched_step, make_rollout)
from test_torch_gen1_fast import F32_TOL, _mismatches

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
B = 4
STEPS = 40
JAX_STEPS = 30
PICKED = (10, 20, 30)


def _setup(config, exact, max_vehicles=512, **cfg_kw):
    """The port's tables, config (the lights under the caller's control),
    spawn table and fresh single-env state for a fixture, on the CPU."""
    eng = Engine(os.path.join(FIX, config), exact=exact, backend="gen1",
                 device="cpu", max_vehicles=max_vehicles)
    cfg = dataclasses.replace(eng.cfg, **{"rl_traffic_light": True,
                                          **cfg_kw})
    return eng, eng._net_dev, cfg, eng._spawn_dev, eng.state


def _phases(eng, steps, seed=0):
    """Per step and env a phase for every intersection, in [0, its phase
    count) where it has phases."""
    n = np.maximum(eng.net.n_phases, 1)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 20, (steps, B, n.size)) % n).astype(
        np.int32)


def _bitwise(a, b):
    if a.dtype.is_floating_point:
        it = torch.int64 if a.dtype == torch.float64 else torch.int32
        return torch.equal(a.view(it), b.view(it))
    return torch.equal(a, b)


def _diff_leaves(stb, singles):
    return [(b, k) for b, s in enumerate(singles) for k in SIM_FIELDS
            if not _bitwise(getattr(stb, k)[b], getattr(s, k))]


@pytest.mark.parametrize("config,exact", [("config_4x4.json", False),
                                          ("config_2x2.json", True)])
def test_batched_step_equals_single_env_steps(config, exact):
    """B = 4 envs with their own phases every step, batched, against the
    same envs stepped one by one as the Engine steps its one env (a (V,)
    state lifted to a batch of one and squeezed back): every SimState leaf
    bit for bit after each of 40 steps."""
    eng, net, cfg, spawn, st0 = _setup(config, exact)
    ph = torch.as_tensor(_phases(eng, STEPS))
    step_b = make_batched_step(net, cfg, with_obs=False, rl_actions=True)
    stb = init_batch_state(cfg, st0, B)
    singles = [st0] * B
    for t in range(STEPS):
        stb, obs = step_b(stb, spawn, ph[t])
        assert obs is None
        singles = [ts.squeeze(ts.step(net, cfg, ts.lift(s.replace_fields(
            phase=ph[t, b].contiguous())), spawn))
            for b, s in enumerate(singles)]
        assert not _diff_leaves(stb, singles), t
    assert int(stb.overflow.max()) == 0
    assert int(stb.running.sum()) > 100 * B
    assert not torch.equal(stb.dis[0], stb.dis[1])   # the phases told


def test_batch_state_copies_do_not_alias():
    """init_batch_state gives each env its own storage."""
    _, _, cfg, _, st0 = _setup("config_2x2.json", False)
    stb = init_batch_state(cfg, st0, 3)
    for k, v in stb.leaves().items():
        assert v.is_contiguous() and v.shape[0] == 3, k
    stb.dis[1].fill_(7.0)
    assert float(stb.dis[0].abs().sum()) == 0.0
    assert float(st0.dis.abs().sum()) == 0.0


def test_split_step_and_rollout_equal_the_monolithic_step():
    """The parts run one by one (1, 2a, 2b, 3: JAX's step_split) equal
    step bit for bit, and make_rollout(n) equals n steps
    (tests/test_batching.py::test_split_phases_equal_monolithic, restated
    on config_4x4.json). step runs the same parts (step_split is step),
    so this checks only that the parts compose."""
    _, net, cfg, spawn, st0 = _setup("config_4x4.json", False,
                                     rl_traffic_light=False)
    assert ts.step_split is ts.step
    a = b = init_batch_state(cfg, st0, B)
    for _ in range(STEPS):
        a = ts.step(net, cfg, a, spawn)
        b, arr = ts.step_part1(net, cfg, b, spawn)
        ll_avail, veh_next, own = ts.step_part2a(net, cfg, b, arr)
        buf, ov_hop = ts.step_part2b(net, cfg, b, arr, ll_avail, veh_next,
                                     own)
        b = ts.step_part3(net, cfg, b, arr, buf, ov_hop)
    assert not [k for k in SIM_FIELDS
                if not _bitwise(getattr(a, k), getattr(b, k))]
    r = make_rollout(net, cfg, STEPS)(init_batch_state(cfg, st0, B), spawn)
    assert not [k for k in SIM_FIELDS
                if not _bitwise(getattr(a, k), getattr(r, k))]
    assert int(a.running.sum()) > 0 and int(a.overflow.max()) == 0


@pytest.mark.parametrize("lane_change,history",
                         [(True, False), (False, True), (True, True)],
                         ids=["lane-change", "history", "both"])
def test_batched_lane_change_and_history_equal_single_env_steps(
        lane_change, history):
    """Lane change and the DURATION history at B = 2, each env with its
    own phases every step, step as the two envs stepped one by one (a
    batch of one each): every SimState leaf bit for bit after each of 20
    steps (config_2x2_lc.json, fast mode)."""
    eng, net, cfg, spawn, st0 = _setup("config_2x2_lc.json", False)
    cfg = dataclasses.replace(cfg, lane_change=lane_change,
                              track_history=history)
    if history:
        st0 = init_state(cfg, eng.net.num_inters, eng.net.phase_time,
                         eng.net.n_phases, eng.net.phase_offset, "cpu")
    ph = torch.as_tensor(_phases(eng, 20, seed=5)[:, :2])
    step_b = make_batched_step(net, cfg, with_obs=False, rl_actions=True)
    stb = init_batch_state(cfg, st0, 2)
    singles = [st0] * 2
    for t in range(20):
        stb = step_b(stb, spawn, ph[t])[0]
        singles = [ts.squeeze(ts.step(net, cfg, ts.lift(s.replace_fields(
            phase=ph[t, b].contiguous())), spawn))
            for b, s in enumerate(singles)]
        assert not _diff_leaves(stb, singles), t
    assert int(stb.overflow.max()) == 0
    assert not torch.equal(stb.dis[0], stb.dis[1])   # the phases told
    if history:
        assert stb.hist_ring_num.shape[:2] == (2, cfg.history_len + 1)
        assert (stb.hist_t == 40 if lane_change else stb.hist_t == 20).all()
        assert not torch.equal(stb.hist_ssum[0], stb.hist_ssum[1])


# ---------------------------------------------------------------------------
# against the JAX package's vmapped step
# ---------------------------------------------------------------------------

def _jstate(leaves):
    return jstate.SimState(**{k: jnp.asarray(v) for k, v in leaves.items()})


@partial(jax.jit, static_argnums=(1,))
def _jax_spawn_admit(net, cfg, st, spawn):
    def one(s):
        s1 = js.spawn_vehicles(net, cfg, s, spawn)
        s2 = js.admit_waiting(net, cfg, s1, dict(last_of=s1.last_of_drv))[0]
        return s1, s2
    return jax.vmap(one)(st)


@pytest.fixture(scope="module")
def jax_batched():
    """JAX's make_batched_step(rl_actions=True) on config_4x4.json in fast
    mode, B = 4 with per-env phases: each step's state before and after as
    numpy leaves, and JAX's spawn and admission phases on the PICKED
    states."""
    eng, net, cfg, spawn, st0 = _setup("config_4x4.json", False)
    jnet = _net_device_arrays(eng.net, np.float32)
    jcfg = jstate.StepConfig(**dataclasses.asdict(cfg))
    jspawn = {k: jnp.asarray(v.numpy()) for k, v in spawn.items()}
    step_b = jbatch.make_batched_step(jnet, jcfg, with_obs=False,
                                      rl_actions=True)
    ph = _phases(eng, JAX_STEPS, seed=3)
    st = jbatch.init_batch_state(jcfg, _jstate(sim_state_to_numpy(st0)), B)
    pairs, phased = [], {}
    for t in range(JAX_STEPS):
        prev = {k: np.asarray(v) for k, v in _leaves(st).items()}
        st, _ = step_b(st, jspawn, jnp.asarray(ph[t]))
        pairs.append((prev, ph[t], {k: np.asarray(v)
                                    for k, v in _leaves(st).items()}))
        if t + 1 in PICKED:
            s1, s2 = _jax_spawn_admit(jnet, jcfg, st, jspawn)
            phased[t + 1] = (_leaves_np(st), _leaves_np(s1), _leaves_np(s2))
    return dict(net=net, cfg=cfg, spawn=spawn, pairs=pairs, phased=phased)


def _leaves(st):
    return {k: getattr(st, k) for k in SIM_FIELDS}


def _leaves_np(st):
    return {k: np.asarray(v) for k, v in _leaves(st).items()}


def test_batched_fast_step_matches_jax(jax_batched):
    """The port's batched fast step from JAX's batched state, with JAX's
    phases, against JAX's next state, every step of 30: ints and bools
    exact, floats within 1e-5 of the leaf's scale."""
    d = jax_batched
    step_b = make_batched_step(d["net"], d["cfg"], with_obs=False,
                               rl_actions=True)
    bad = {}
    for t, (prev, ph, want) in enumerate(d["pairs"]):
        got, _ = step_b(sim_state_from_numpy(prev, "cpu", torch.float32),
                        d["spawn"], torch.as_tensor(ph))
        diff = _mismatches(sim_state_to_numpy(got), want, F32_TOL)
        if diff:
            bad[t + 1] = diff
    assert not bad, f"first differing step {min(bad)}: {bad[min(bad)]}"
    assert d["pairs"][-1][2]["running"].sum() > 100 * B


@pytest.mark.parametrize("t", PICKED)
def test_spawn_and_admission_match_jax(jax_batched, t):
    """G11 and G12 (plain) against JAX's spawn_vehicles and admit_waiting
    on JAX's batched state after step t: G11 leaf for leaf, bitwise;
    G12's admission, and the state after the port's admit_waiting (G12,
    then the leader scan), bitwise."""
    d = jax_batched
    st, s1, s2 = d["phased"][t]
    cfg = d["cfg"]
    port = sim_state_from_numpy(st, "cpu", torch.float32)
    out = spawn_slots_plain(port, d["spawn"], d["net"]["flow_params"],
                            d["net"]["interval"], cfg.max_spawn_per_step)
    got1 = port.replace_fields(**out)
    assert not _mismatches(sim_state_to_numpy(got1), s1, 0.0)
    assert (s1["spawn_cursor"] > st["spawn_cursor"]).any()
    h = admit_heads_plain(got1.active, got1.running, got1.drv, got1.uid,
                          got1.dis, got1.params, got1.leader, got1.gap,
                          got1.list_seq, got1.last_of_drv, got1.seq_counter,
                          cfg.num_lanes)
    np.testing.assert_array_equal(h["running"].numpy(), s2["running"])
    np.testing.assert_array_equal(h["list_seq"].numpy(), s2["list_seq"])
    assert bool((h["head"] >= 0).any())
    got2 = ts.admit_waiting(d["net"], cfg, got1,
                            dict(last_of=got1.last_of_drv))[0]
    assert not _mismatches(sim_state_to_numpy(got2), s2, 0.0)


def test_the_picked_steps_spawn_and_admit(jax_batched):
    """The states the phase tests start from do spawn and admit."""
    phased = jax_batched["phased"].values()
    assert any((s1["active"] & ~st["active"]).any() for st, s1, _ in phased)
    assert any((s2["running"] & ~s1["running"]).any()
               for _, s1, s2 in phased)


def test_spawn_into_a_full_pool_matches_jax():
    """G11 (plain) against JAX's spawn_vehicles where the due rows outnumber
    the free slots: the same slots filled, the same cursor, OV_SLOTS set
    (config_2x2.json, a pool of 64, B = 2, from the first step whose
    spawn overflows)."""
    eng, net, cfg, spawn, st0 = _setup("config_2x2.json", False,
                                       max_vehicles=64)
    st = init_batch_state(cfg, st0, 2)
    for _ in range(60):
        nxt = ts.step(net, cfg, st, spawn)
        if int(nxt.overflow.max()):
            break
        st = nxt
    assert int(nxt.overflow.max()) & 1, "the pool never overflowed"
    out = spawn_slots_plain(st, spawn, net["flow_params"], net["interval"],
                            cfg.max_spawn_per_step)
    assert (out["overflow"] & 1).all()
    jnet = _net_device_arrays(eng.net, np.float32)
    jcfg = jstate.StepConfig(**dataclasses.asdict(cfg))
    jspawn = {k: jnp.asarray(v.numpy()) for k, v in spawn.items()}
    want = jax.jit(jax.vmap(lambda s: js.spawn_vehicles(
        jnet, jcfg, s, jspawn)))(_jstate(sim_state_to_numpy(st)))
    got = st.replace_fields(**out)
    assert not _mismatches(sim_state_to_numpy(got), _leaves_np(want), 0.0)
