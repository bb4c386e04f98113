"""The ring DQN learner of the PyTorch port (rl/dqn.py, rl/ring_dqn.py)
against the JAX package's (rl/dqn.py, rl/ring_dqn.py with optax), on the
CPU, from the same parameters (carry.qparams_from_numpy) and the same
inputs.

Q-values, the masked Q-values, the Double-DQN TD loss and its gradients
hold within 1e-5 relative; the clipped Adam update within 1e-6 relative of
optax's (torch.optim.Adam and optax.adam differ by rounding only); the
observation builder is exact; eps-greedy actions are equal at eps=0 (the
draws come from a torch.Generator, whose stream is not jax.random's).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cityflow_tpu import ring_sim as jax_ring_sim
from cityflow_tpu.compiler.net import compile_scenario as jax_compile
from cityflow_tpu.core import ring as jax_ring
from cityflow_tpu.rl import dqn as jax_dqn
from cityflow_tpu.rl import ring_dqn as jax_ring_dqn

from cityflow_tpu_torch.carry import qparams_from_numpy
from cityflow_tpu_torch.rl import dqn, ring_dqn
from cityflow_tpu_torch.rl.env import RingVecEnv
from test_torch_ring import port_leaves

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "fixtures", "config_4x4_rl.json")
B, WARM, HIDDEN = 4, 30, 64
REL = 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_state(st):
    return jax_ring.RingState(**{k: jnp.asarray(v)
                                 for k, v in port_leaves(st).items()})


@pytest.fixture(scope="module")
def warm():
    """The port's env on config_4x4_rl.json at B=4 after WARM steps under
    MaxPressure (waiting traffic), JAX's sim of the same config, and
    parameters from JAX's init_params."""
    env = RingVecEnv(CONFIG, batch=B, horizon=WARM + 32, device="cpu")
    env.reset()
    for t in range(WARM):
        env.step(env.max_pressure_actions())
    jsim = jax_ring_sim.build_sim(jax_compile(CONFIG), horizon=WARM + 32)
    P = env._max_phases
    obs_dim = 3 * P
    jp = jax_dqn.init_params(jax.random.PRNGKey(0), obs_dim, HIDDEN, P)
    return env, jsim, P, jp


def _inputs(P, G, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1, 2, (B, G, 3 * P)).astype(np.float32)
    obs_next = rng.uniform(-1, 2, (B, G, 3 * P)).astype(np.float32)
    n_ph = rng.integers(0, P + 1, G).astype(np.int32)
    actions = (rng.integers(0, 1 << 20, (B, G))
               % np.maximum(n_ph, 1)).astype(np.int32)
    rewards = rng.uniform(-3, 0, (B, G)).astype(np.float32)
    return obs, obs_next, n_ph, actions, rewards


def test_q_values_loss_and_gradients_match_jax(warm):
    env, _, P, jp = warm
    G = env.sim.cfg.G
    obs, obs_next, n_ph, actions, rewards = _inputs(P, G)
    tp = qparams_from_numpy(jp, "cpu")
    target_j = jax_dqn.init_params(jax.random.PRNGKey(1), 3 * P, HIDDEN, P)
    tt = qparams_from_numpy(target_j, "cpu")
    T = torch.as_tensor
    np.testing.assert_allclose(
        _np(dqn.q_values(tp, T(obs))),
        np.asarray(jax_dqn.q_values(jp, jnp.asarray(obs))), rtol=REL,
        atol=1e-6)
    want = np.asarray(jax.vmap(lambda o: jax_ring_dqn._masked_q(
        jp, o, jnp.asarray(n_ph)))(jnp.asarray(obs)))
    got = _np(dqn.masked_q(tp, T(obs), T(n_ph)))
    assert np.array_equal(np.isinf(want), np.isinf(got))
    assert np.isinf(want).any() and np.isfinite(want).any()
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=REL, atol=1e-6)
    jl, jg = jax.value_and_grad(jax_ring_dqn._td_loss)(
        jp, target_j, jnp.asarray(obs), jnp.asarray(actions),
        jnp.asarray(rewards), jnp.asarray(obs_next), jnp.asarray(n_ph), 0.9)
    tl = dqn.td_loss(tp, tt, T(obs), T(actions), T(rewards),
                     T(obs_next), T(n_ph), 0.9)
    tg = torch.autograd.grad(tl, list(tp))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=REL)
    for k, g in zip(dqn.QParams._fields, tg):
        w = np.asarray(getattr(jg, k))
        np.testing.assert_allclose(_np(g), w, rtol=REL,
                                   atol=REL * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("scale, clipped", [(40.0, True), (0.05, False)],
                         ids=["clip_active", "clip_inactive"])
def test_clipped_adam_update_matches_optax(warm, scale, clipped):
    """Two updates of optax.chain(clip_by_global_norm(5), adam(1e-3))
    against the port's clip + torch.optim.Adam; the clip is optax's rule,
    g * 5 / |g| only when |g| >= 5."""
    _, _, P, jp = warm
    rng = np.random.default_rng(1)
    grads = [[rng.standard_normal(np.shape(getattr(jp, k))).astype(
        np.float32) * scale for k in dqn.QParams._fields] for _ in range(2)]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads[0]))
    assert (norm >= 5.0) == clipped
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    jparams, jstate = jp, tx.init(jp)
    tp = qparams_from_numpy(jp, "cpu")
    opt = torch.optim.Adam(list(tp), lr=1e-3)
    for gs in grads:
        jg = jax_dqn.QParams(*(jnp.asarray(g) for g in gs))
        clip_j, _ = optax.clip_by_global_norm(5.0).update(jg, None)
        clip_t = dqn.clip_by_global_norm([torch.as_tensor(g)
                                          for g in gs])
        for a, b in zip(clip_j, clip_t):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                       atol=0)
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        dqn.apply_update(tp, opt, [torch.as_tensor(g) for g in gs])
    for k, t in zip(dqn.QParams._fields, tp):
        w = np.asarray(getattr(jparams, k))
        np.testing.assert_allclose(_np(t), w, rtol=1e-6, atol=1e-8,
                                   err_msg=k)
        assert not np.array_equal(w, np.asarray(getattr(jp, k)))


def test_clip_is_not_clip_grad_norm():
    """torch's clip_grad_norm_ divides by |g| + 1e-6: a different rule,
    which the learner does not use."""
    g = torch.full((4,), 5.0)
    want = (g / 10.0) * 5.0
    got = dqn.clip_by_global_norm([g])[0]
    assert torch.equal(got, want)
    p = torch.zeros(4, requires_grad=True)
    p.grad = g.clone()
    torch.nn.utils.clip_grad_norm_([p], 5.0)
    assert not torch.equal(p.grad, want)


def test_intersection_obs_matches_jax_exactly(warm):
    """build_ring_intersection_obs from the warmed state, with some phases
    out of [0, P): their one-hot is all zeros, as jax.nn.one_hot gives."""
    env, jsim, P, _ = warm
    cfg = env.sim.cfg
    st = env.state
    phase = st.phase.clone()
    phase[0, 0], phase[1, 1], phase[2, 2] = P, -1, P + 3
    st = st.replace_fields(phase=phase)
    obs_fn, dim = ring_dqn.build_ring_intersection_obs(cfg, P)
    obs, w_up = obs_fn(env.sim.tables, st)
    jfn, jdim = jax_ring_dqn.build_ring_intersection_obs(jsim.cfg, P)
    jobs, jw = jax.jit(jax.vmap(jfn, in_axes=(None, -1), out_axes=0))(
        jsim.tables, _jax_state(st))
    assert dim == jdim == obs.shape[-1]
    np.testing.assert_array_equal(_np(obs), np.asarray(jobs))
    np.testing.assert_array_equal(_np(w_up), np.asarray(jw))
    assert _np(obs)[0, 0, 2 * P:].sum() == 0 == _np(obs)[1, 1, 2 * P:].sum()
    assert _np(w_up).sum() > 0 and (_np(obs)[..., :2 * P] != 0).any()


def test_eps_greedy_matches_jax_at_eps_0(warm):
    env, jsim, P, jp = warm
    tp = qparams_from_numpy(jp, "cpu")
    obs, _, _, _, _ = _inputs(P, env.sim.cfg.G, seed=2)
    n_ph = env.sim.tables["g_n_phases"]
    jt = dict(g_n_phases=jnp.asarray(n_ph.numpy()))
    gen = torch.Generator().manual_seed(0)
    ja, _ = jax_ring_dqn._eps_greedy(jt, jp, jnp.asarray(obs),
                                     jax.random.PRNGKey(0), 0.0)
    ta = ring_dqn._eps_greedy(env.sim.tables, tp, torch.as_tensor(obs), gen,
                              0.0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # eps > 0: the draws differ from jax.random's; only the ranges hold
    hi = np.maximum(n_ph.numpy(), 1)[None]
    for eps in (0.3, 1.0):
        a = ring_dqn._eps_greedy(env.sim.tables, tp, torch.as_tensor(obs),
                                 gen, eps).numpy()
        assert a.dtype == np.int32 and (a >= 0).all() and (a < hi).all()
        if eps == 1.0:
            assert not np.array_equal(a, ta.numpy())


def test_split_step_two_iterations_match_jax(warm):
    """Two iterations of make_ring_dqn_split_step at B=4, eps=0, from the
    warmed state and the same parameters: equal actions and rewards, the
    loss within 1e-5 relative, the updated parameters within 1e-5 of
    JAX's, and the env stepped 2 x 5 steps."""
    env, jsim, P, jp = warm
    cfg = env.sim.cfg
    assert jsim.cfg.rl_traffic_light and cfg.rl_traffic_light
    _, iter_j = jax_ring_dqn.make_ring_dqn_split_step(jsim.tables, jsim.cfg,
                                                      P)
    _, iter_t = ring_dqn.make_ring_dqn_split_step(env.sim.tables, cfg, P)
    jparams, jopt = jp, optax.chain(optax.clip_by_global_norm(5.0),
                                    optax.adam(1e-3)).init(jp)
    tp = qparams_from_numpy(jp, "cpu")
    tgt_t, tgt_j = dqn.copy_params(tp), jp
    opt = torch.optim.Adam(list(tp), lr=1e-3)
    jst = _jax_state(env.state)
    tst = env.state
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    step0 = int(tst.step[0])
    for i in range(2):
        jparams, jopt, jst, key, jm = iter_j(
            jsim.tables, jparams, tgt_j, jopt, jst, jsim.q, key, 0.0)
        tp, opt, tst, gen, tm = iter_t(env.sim.tables, tp, tgt_t, opt, tst,
                                       env.sim.q, gen, 0.0)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=REL, err_msg=f"iteration {i}")
        np.testing.assert_allclose(float(tm["mean_reward"]),
                                   float(jm["mean_reward"]), rtol=1e-6)
        np.testing.assert_array_equal(tst.phase.numpy(),
                                      np.asarray(jst.phase))
        np.testing.assert_array_equal(tst.n_l.numpy(), np.asarray(jst.n_l))
        for k, t in zip(dqn.QParams._fields, tp):
            w = np.asarray(getattr(jparams, k))
            np.testing.assert_allclose(_np(t), w, rtol=0, atol=REL,
                                       err_msg=f"{k} iteration {i}")
    assert int(tst.step[0]) == step0 + 10 and int(tst.overflow.max()) == 0
    assert float(jm["loss"]) > 0
