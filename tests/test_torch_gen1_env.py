"""The gen-1 RL surface of the PyTorch port (core/observe.py, rl/policies.py
on G13 lane_counts and G14 phase_scores, rl/env.CityFlowVecEnv and the
gen-1 DQN of rl/dqn.py) against the JAX package's, on the CPU, where the
kernel wrappers take their plain versions.

Counts, waiting counts, pressures, features and actions are sums of small
integers, so they must be equal; avg_travel_time (an in-flight float sum
in another order) within 1e-5 relative. The functions run on JAX's own
batched states of config_4x4_rl.json under MaxPressure; the env runs
against JAX's at B = 4, and against the port's own RingVecEnv as
tests/test_ring_env.py holds JAX's two envs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cityflow_tpu.core import observe as jobs
from cityflow_tpu.core import state as jstate
from cityflow_tpu.rl import dqn as jdqn
from cityflow_tpu.rl import policies as jpol
from cityflow_tpu.rl.env import CityFlowVecEnv as JaxVecEnv

from cityflow_tpu_torch.carry import qparams_from_numpy, sim_state_from_numpy
from cityflow_tpu_torch.core import observe
from cityflow_tpu_torch.core.state import SIM_FIELDS
from cityflow_tpu_torch.rl import dqn, policies
from cityflow_tpu_torch.rl.env import CityFlowVecEnv, RingVecEnv

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
RL = os.path.join(FIX, "config_4x4_rl.json")
B = 4
STEPS = 40
MP_EVERY = 5
PICKED = (15, 30, 40)
REL = 1e-5
OBS_EXACT = ("lane_count", "lane_waiting", "pressure", "vehicle_count",
             "current_time")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _run(env, steps, picked=()):
    """MaxPressure every MP_EVERY steps (phase 0 until the first decision):
    the actions at each decision, each step's observations and reward,
    and the states after the `picked` steps as numpy leaves."""
    env.reset()
    phases = np.zeros((env.batch, env.num_intersections), np.int32)
    actions, obs, states = {}, [], {}
    for t in range(steps):
        if t % MP_EVERY == 0 and t > 0:
            phases = _np(env.max_pressure_actions()).astype(np.int32)
            actions[t] = phases
        o, r = env.step(phases if isinstance(env, JaxVecEnv)
                        else torch.as_tensor(phases))
        obs.append(({k: _np(v) for k, v in o.items()}, _np(r)))
        if t + 1 in picked:
            states[t + 1] = {k: _np(getattr(env.state, k))
                             for k in SIM_FIELDS}
    return actions, obs, states


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's CityFlowVecEnv on config_4x4_rl.json, B = 4,
    STEPS steps under MaxPressure."""
    je = JaxVecEnv(RL, batch=B, max_vehicles=512, horizon=STEPS + 8)
    pe = CityFlowVecEnv(RL, batch=B, max_vehicles=512, horizon=STEPS + 8,
                        device="cpu")
    return dict(jax=_run(je, STEPS, PICKED), port=_run(pe, STEPS), je=je,
                pe=pe)


def test_vec_env_matches_jax(runs):
    """Equal actions at every decision; equal counts, pressures, times and
    rewards every step; avg_travel_time within 1e-5 relative."""
    ja, jo, _ = runs["jax"]
    pa, po, _ = runs["port"]
    assert ja.keys() == pa.keys() and len(ja) == STEPS // MP_EVERY - 1
    for t in ja:
        np.testing.assert_array_equal(pa[t], ja[t], err_msg=f"step {t}")
    for t, ((jd, jr), (pd, pr)) in enumerate(zip(jo, po)):
        assert jd.keys() == pd.keys()
        for k in OBS_EXACT:
            np.testing.assert_array_equal(pd[k], jd[k],
                                          err_msg=f"{k} step {t}")
        np.testing.assert_allclose(pd["avg_travel_time"],
                                   jd["avg_travel_time"], rtol=REL)
        np.testing.assert_array_equal(pr, jr)
    assert jo[-1][0]["vehicle_count"].min() > 100
    assert any((a != ja[MP_EVERY]).any() for a in ja.values())


def _jfn(name, jnet, jcfg, P):
    fns = {
        "lane_vehicle_count": lambda s: jobs.lane_vehicle_count(jcfg, s),
        "lane_waiting_vehicle_count":
            lambda s: jobs.lane_waiting_vehicle_count(jcfg, s),
        "drivable_vehicle_count":
            lambda s: jobs.drivable_vehicle_count(jcfg, s),
        "intersection_pressure":
            lambda s: jobs.intersection_pressure(jnet, jcfg, s),
        "avg_travel_time": lambda s: jobs._avg_travel_time(jcfg, s),
        "observations": lambda s: jobs.observations(jnet, jcfg, s),
        "phase_pressures":
            lambda s: jpol.phase_pressures(jnet, jcfg, s, P),
        "max_pressure_phases":
            lambda s: jpol.max_pressure_phases(jnet, jcfg, s, P),
        "build_intersection_obs":
            lambda s: jdqn.build_intersection_obs(jnet, jcfg, P)[0](jnet, s),
    }
    return jax.jit(jax.vmap(fns[name]))


def _pfn(name, net, cfg, P, st):
    if name in ("lane_vehicle_count", "lane_waiting_vehicle_count",
                "drivable_vehicle_count"):
        return getattr(observe, name)(cfg, st)
    if name == "avg_travel_time":
        return observe._avg_travel_time(cfg, st)
    if name in ("intersection_pressure", "observations"):
        return getattr(observe, name)(net, cfg, st)
    if name in ("phase_pressures", "max_pressure_phases"):
        return getattr(policies, name)(net, cfg, st, P)
    obs_fn, dim = dqn.build_intersection_obs(net, cfg, P)
    out = obs_fn(net, st)
    assert out.shape[-1] == dim
    return out


FUNCS = ("lane_vehicle_count", "lane_waiting_vehicle_count",
         "drivable_vehicle_count", "intersection_pressure",
         "avg_travel_time", "observations", "phase_pressures",
         "max_pressure_phases", "build_intersection_obs")


@pytest.mark.parametrize("name", FUNCS)
def test_observation_functions_match_jax(runs, name):
    """Each core/observe.py and rl/policies.py function and the DQN's
    observation on JAX's batched states after the PICKED steps."""
    je, pe = runs["je"], runs["pe"]
    P = pe._max_phases
    jf = _jfn(name, je._net_dev, je.cfg, P)
    for t, leaves in runs["jax"][2].items():
        jst = jstate.SimState(**{k: jnp.asarray(v)
                                 for k, v in leaves.items()})
        want = jf(jst)
        got = _pfn(name, pe._net_dev, pe.cfg, P,
                   sim_state_from_numpy(leaves, "cpu", torch.float32))
        if not isinstance(want, dict):
            want, got = {name: want}, {name: got}
        for k in want:
            w, g = np.asarray(want[k]), _np(got[k])
            assert g.shape == w.shape, (k, g.shape, w.shape)
            if k == "avg_travel_time":
                np.testing.assert_allclose(g, w, rtol=REL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{k} at {t}")
    assert (np.asarray(want[k]) != 0).any()


def test_vec_env_matches_the_ring_env():
    """The port's CityFlowVecEnv against its RingVecEnv on config_4x4.json
    (tests/test_ring_env.py restated): MaxPressure agrees on at least 95%
    of the intersections, lane counts equal every step, waiting counts on
    99.9% of the lanes, rewards close."""
    path = os.path.join(FIX, "config_4x4.json")
    e1 = CityFlowVecEnv(path, batch=B, max_vehicles=512, horizon=128,
                        device="cpu")
    e2 = RingVecEnv(path, batch=B, horizon=128, device="cpu")
    e1.reset()
    e2.reset()
    phases = torch.zeros((B, e1.num_intersections), dtype=torch.int32)
    for t in range(STEPS):
        if t % MP_EVERY == 0 and t > 0:
            a1, a2 = _np(e1.max_pressure_actions()), \
                _np(e2.max_pressure_actions())
            assert (a1 == a2).mean() >= 0.95, t
            phases = torch.as_tensor(a2)
        o1, r1 = e1.step(phases)
        o2, r2 = e2.step(phases)
        np.testing.assert_array_equal(_np(o1["lane_count"]),
                                      _np(o2["lane_count"]))
        assert (_np(o1["lane_waiting"]) == _np(o2["lane_waiting"])).mean() \
            > 0.999, t
        assert np.allclose(_np(r1), _np(r2))
    assert int(o1["vehicle_count"].min()) > 100


def test_dqn_two_iterations_match_jax(runs):
    """Two make_dqn_train_step iterations at eps = 0 (one sim step per
    action) from JAX's state after STEPS steps and JAX's initial
    parameters: equal actions, the loss within 1e-5 relative and the
    updated parameters within 1e-5 of JAX's."""
    je, pe = runs["je"], runs["pe"]
    P = pe._max_phases
    leaves = runs["jax"][2][STEPS]
    init_j, step_j = jdqn.make_dqn_train_step(je._net_dev, je.cfg, P,
                                              sim_steps_per_action=1)
    jp, jopt = init_j(jax.random.PRNGKey(0))
    step_j = jax.jit(step_j)
    _, step_t = dqn.make_dqn_train_step(pe._net_dev, pe.cfg, P,
                                        sim_steps_per_action=1)
    tp = qparams_from_numpy(jp, "cpu")
    tgt_t, tgt_j = dqn.copy_params(tp), jp
    opt = torch.optim.Adam(list(tp), lr=1e-3)
    jst = jstate.SimState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tst = sim_state_from_numpy(leaves, "cpu", torch.float32)
    key, gen = jax.random.PRNGKey(1), torch.Generator().manual_seed(1)
    for i in range(2):
        jp, jopt, jst, key, jm = step_j(je._net_dev, jp, tgt_j, jopt, jst,
                                        je._spawn, key, 0.0)
        tp, opt, tst, gen, tm = step_t(pe._net_dev, tp, tgt_t, opt, tst,
                                       pe._spawn, gen, 0.0)
        np.testing.assert_array_equal(tst.phase.numpy(),
                                      np.asarray(jst.phase))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=REL, err_msg=f"iteration {i}")
        np.testing.assert_allclose(float(tm["mean_reward"]),
                                   float(jm["mean_reward"]), rtol=1e-6)
        for k, t in zip(dqn.QParams._fields, tp):
            np.testing.assert_allclose(_np(t), np.asarray(getattr(jp, k)),
                                       rtol=0, atol=REL,
                                       err_msg=f"{k} iteration {i}")
    assert float(jm["loss"]) > 0 and int(tst.step[0]) == STEPS + 2


def test_dqn_train_runs_on_the_cpu():
    """rl/dqn.train end to end at a tiny size: finite losses."""
    hist = dqn.train(os.path.join(FIX, "config_2x2.json"), batch=2, iters=2,
                     max_vehicles=256, device="cpu")
    assert len(hist) == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["mean_reward"])
               for h in hist)


def test_dqn_train_from_a_warm_state():
    """rl/dqn.train from a warm-up's state (one CityFlowVecEnv env under
    MaxPressure for 60 steps, copied into B = 2 envs): it goes on from that
    state's step and spawn cursor, and vehicles wait there, so the reward
    is not zero."""
    from cityflow_tpu_torch.parallel.batch import init_batch_state
    env = CityFlowVecEnv(RL, batch=1, horizon=200, device="cpu")
    env.reset()
    for t in range(60):
        env.step(env.max_pressure_actions() if t % MP_EVERY == 0
                 else env.state.phase)
    warm = init_batch_state(env.cfg, env.state.map(lambda x: x[0]), 2)
    cursor = warm.spawn_cursor.clone()      # train writes `warm` (donated)
    seen = []
    hist = dqn.train(RL, iters=2, device="cpu", state=warm,
                     on_iter=lambda i, m, s: seen.append(s))
    end = seen[-1]
    assert end.active.shape == warm.active.shape
    np.testing.assert_array_equal(_np(end.step), [70, 70])
    assert (end.spawn_cursor >= cursor).all()
    assert int(end.overflow.max()) == 0
    assert any(h["mean_reward"] < 0 for h in hist)
    assert all(np.isfinite(h["loss"]) for h in hist)
