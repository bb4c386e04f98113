"""The RL control path of the PyTorch port (core/ring_observe.py with O1
lane_stats and O2 phase_pressure, rl/env.RingVecEnv) against the JAX
package's, on the CPU, where both kernel wrappers take their plain
versions.

Every ring_observe function runs from JAX's own states at several steps of
config_4x4_rl.json under MaxPressure: counts, waiting counts, pressures,
features and actions are sums of small integers, so they must be equal;
avg_travel_time within 1e-5 relative. RingVecEnv runs against JAX's
RingVecEnv on config_4x4.json at B=4, and inside the port batched against
one env, bitwise.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cityflow_tpu import ring_sim as jax_ring_sim
from cityflow_tpu.compiler.net import compile_scenario as jax_compile
from cityflow_tpu.core import ring as jax_ring
from cityflow_tpu.core import ring_observe as jax_obs
from cityflow_tpu.rl.env import RingVecEnv as JaxRingVecEnv

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.carry import ring_state_from_numpy
from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.core import ring_observe
from cityflow_tpu_torch.rl.env import RingVecEnv
from test_torch_ring import jax_leaves, port_leaves

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
RL = os.path.join(FIX, "config_4x4_rl.json")
STEPS = 60
PICKED = (10, 25, 40, 55, 60)
REL = 1e-5


@pytest.fixture(scope="module")
def rl_run():
    """JAX's single-env run of config_4x4_rl.json with MaxPressure phases
    set every 5 steps; the states after the PICKED steps as numpy leaves,
    and the tables of both packages."""
    jsim = jax_ring_sim.build_sim(jax_compile(RL), horizon=STEPS + 8)
    tsim = ring_sim.build_sim(compile_scenario(RL), horizon=STEPS + 8,
                              device="cpu")
    assert jsim.cfg.rl_traffic_light and tsim.cfg.rl_traffic_light
    mp = int(jsim.net.n_phases.max())
    st, states = jsim.state, {}
    for t in range(1, STEPS + 1):
        if t % 5 == 0:
            st = st.replace_fields(phase=jax_obs.max_pressure_phases_ring(
                jsim.tables, jsim.cfg, st, mp))
        st = jax_ring.ring_step(jsim.tables, jsim.cfg, st, jsim.q)
        if t in PICKED:
            states[t] = jax_leaves(st)
    return jsim, tsim, mp, states


def _jax_out(name, jsim, mp, st):
    t, c = jsim.tables, jsim.cfg
    if name == "lane_counts_ring":
        return jax_obs.lane_counts_ring(c, st)
    if name == "lane_waiting_ring":
        return jax_obs.lane_waiting_ring(c, st)
    if name == "to_original_lane_order":
        return jax_obs.to_original_lane_order(
            t, jax_obs.lane_waiting_ring(c, st))
    if name == "observations_ring":
        return jax_obs.observations_ring(t, c, st)
    return getattr(jax_obs, name)(t, c, st, mp)


def _port_out(name, tsim, mp, st):
    t, c = tsim.tables, tsim.cfg
    if name == "lane_counts_ring":
        return ring_observe.lane_counts_ring(c, st)
    if name == "lane_waiting_ring":
        return ring_observe.lane_waiting_ring(c, st)
    if name == "to_original_lane_order":
        return ring_observe.to_original_lane_order(
            t, ring_observe.lane_waiting_ring(c, st))
    if name == "observations_ring":
        return ring_observe.observations_ring(t, c, st)
    return getattr(ring_observe, name)(t, c, st, mp)


def _flat(x):
    if isinstance(x, dict):
        return [(k, x[k]) for k in sorted(x)]
    if isinstance(x, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(x)]
    return [("", x)]


@pytest.mark.parametrize("name", [
    "lane_counts_ring", "lane_waiting_ring", "to_original_lane_order",
    "phase_pressures", "phase_features", "max_pressure_phases_ring",
    "observations_ring"])
def test_observe_function_matches_jax(rl_run, name):
    jsim, tsim, mp, states = rl_run
    nonzero = set()
    for t, leaves in states.items():
        jst = jax_ring.RingState(**{k: jnp.asarray(v)
                                    for k, v in leaves.items()})
        tst = ring_state_from_numpy(leaves, "cpu").map(lambda x: x[..., None])
        want, got = _flat(_jax_out(name, jsim, mp, jst)), \
            _flat(_port_out(name, tsim, mp, tst))
        assert [k for k, _ in want] == [k for k, _ in got]
        for (k, w), (_, g) in zip(want, got):
            w, g = np.asarray(w), g[..., 0].numpy()
            msg = f"{name} {k} after step {t}"
            assert w.shape == g.shape, msg
            if (np.isfinite(w) & (w != 0)).any():
                nonzero.add(k)
            if k == "avg_travel_time":
                np.testing.assert_allclose(g, w, rtol=REL, err_msg=msg)
            else:
                # integers, or sums of small integers in float32 (-inf where
                # a phase is missing): equal
                np.testing.assert_array_equal(g, w.astype(g.dtype),
                                              err_msg=msg)
    # every output (each of the features, the per-env observations) takes
    # a non-zero value in some picked state
    assert nonzero == {k for k, _ in want}, nonzero


# ---------------------------------------------------------------------------
# RingVecEnv
# ---------------------------------------------------------------------------

ENV_STEPS, B = 40, 4


@pytest.fixture(scope="module")
def env_run():
    """JAX's and the port's RingVecEnv on config_4x4.json at B=4, each
    under its own MaxPressure actions every 5 steps, and the port's B=1 env
    under the actions of its env 0; per step the observations, rewards and
    the actions taken."""
    cfg = os.path.join(FIX, "config_4x4.json")
    je = JaxRingVecEnv(cfg, batch=B, horizon=ENV_STEPS + 8)
    te = RingVecEnv(cfg, batch=B, horizon=ENV_STEPS + 8, device="cpu")
    t1 = RingVecEnv(cfg, batch=1, horizon=ENV_STEPS + 8, device="cpu")
    for e in (je, te, t1):
        e.reset()
    I = te.num_intersections
    ja = np.zeros((B, I), np.int32)
    ta = torch.zeros((B, I), dtype=torch.int32)
    rows = []
    for t in range(ENV_STEPS):
        decided = t % 5 == 0 and t > 0
        if decided:
            ja = np.asarray(je.max_pressure_actions())
            ta = te.max_pressure_actions()
        jo, jr = je.step(jnp.asarray(ja))
        to, tr = te.step(ta)
        o1, r1 = t1.step(ta[:1])
        rows.append(dict(decided=decided, ja=ja.copy(), ta=ta.numpy().copy(),
                         jo={k: np.asarray(v) for k, v in jo.items()},
                         to={k: v.numpy() for k, v in to.items()},
                         jr=np.asarray(jr), tr=tr.numpy(),
                         o1={k: v.numpy() for k, v in o1.items()},
                         r1=r1.numpy()))
    return rows, te, t1


def test_ring_vec_env_matches_jax(env_run):
    rows, _, _ = env_run
    decisions = same_waiting = 0
    for t, r in enumerate(rows):
        jo, to = r["jo"], r["to"]
        assert set(jo) == set(to)
        assert to["lane_count"].shape == jo["lane_count"].shape
        np.testing.assert_array_equal(to["lane_count"], jo["lane_count"],
                                      err_msg=f"lane_count step {t}")
        np.testing.assert_array_equal(to["vehicle_count"],
                                      jo["vehicle_count"])
        np.testing.assert_array_equal(to["current_time"], jo["current_time"])
        np.testing.assert_allclose(to["avg_travel_time"],
                                   jo["avg_travel_time"], rtol=REL)
        if np.array_equal(to["lane_waiting"], jo["lane_waiting"]):
            np.testing.assert_array_equal(r["tr"], r["jr"])
        if r["decided"]:
            decisions += 1
            # the actions were chosen on the previous step's waiting
            prev_j, prev_t = rows[t - 1]["jo"], rows[t - 1]["to"]
            if np.array_equal(prev_j["lane_waiting"], prev_t["lane_waiting"]):
                same_waiting += 1
                np.testing.assert_array_equal(r["ta"], r["ja"],
                                              err_msg=f"actions step {t}")
    assert decisions == 7 and same_waiting >= 5, (decisions, same_waiting)
    assert rows[-1]["jo"]["lane_waiting"].sum() > 0
    assert any((r["ja"] != 0).any() for r in rows), "MaxPressure never moved"


def test_ring_vec_env_batched_equals_single_env_bitwise(env_run):
    rows, te, t1 = env_run
    for t, r in enumerate(rows):
        for k, v in r["o1"].items():
            for b in range(B):
                assert np.array_equal(r["to"][k][b], v[0]), f"{k} step {t}"
        assert np.array_equal(r["tr"], np.repeat(r["r1"], B))
    want, got = port_leaves(t1.state), port_leaves(te.state)
    for k, v in want.items():
        for b in range(B):
            assert np.array_equal(got[k][..., b], v[..., 0]), f"{k} env {b}"
