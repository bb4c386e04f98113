"""DQN signal-control learner on the gen-1 batched step (the JAX package's
rl/dqn.py), and the parts both learners share (rl/ring_dqn.py is the
ring's).

Network: a two-layer MLP over per-intersection observations, shared across
intersections (parameter tying): per phase the waiting on its available
upstream lanes and its pressure, and the current phase one-hot. One
iteration observes, picks eps-greedy actions, holds them for
sim_steps_per_action batched gen-1 steps (parallel/batch.py's layout:
leading env axis B) and applies one Double-DQN TD(0) update (Huber loss,
optax's global-norm clip, Adam) against a target network. The features and
the reward come from G13 and G14 (core/observe.py, kernels/phase_scores.py)
on the device.

Where the JAX learner takes a jax.random key and an optax state, this one
takes a torch.Generator and a torch.optim.Adam; the parameters are updated
in place, so the target network is a copy (copy_params). The parameters
keep the JAX package's orientation (obs @ w1, h @ w2), so
carry.qparams_from_numpy moves JAX's QParams across without a transpose.
"""

from typing import NamedTuple

import numpy as np
import torch

MAX_NORM = 5.0


class QParams(NamedTuple):
    w1: torch.Tensor          # (obs_dim, hidden)
    b1: torch.Tensor          # (hidden,)
    w2: torch.Tensor          # (hidden, n_actions)
    b2: torch.Tensor          # (n_actions,)


def init_params(gen: torch.Generator, obs_dim: int, hidden: int,
                n_actions: int, device=None) -> QParams:
    """Weights uniform in +-1/sqrt(fan-in) drawn from `gen` (on `device`),
    biases 0; leaf tensors that require grad."""
    dev = gen.device if device is None else torch.device(device)

    def uni(shape, s):
        u = torch.rand(shape, generator=gen, device=dev)
        return (u * (2 * s) - s).requires_grad_()
    s1 = float(1.0 / np.sqrt(obs_dim))
    s2 = float(1.0 / np.sqrt(hidden))
    zeros = lambda n: torch.zeros(n, device=dev, requires_grad=True)
    return QParams(w1=uni((obs_dim, hidden), s1), b1=zeros(hidden),
                   w2=uni((hidden, n_actions), s2), b2=zeros(n_actions))


def copy_params(p: QParams) -> QParams:
    """A detached copy (the target network; the optimizer updates the
    online parameters in place)."""
    return QParams(*(t.detach().clone() for t in p))


def q_values(p: QParams, obs):
    h = torch.relu(obs @ p.w1 + p.b1)
    return h @ p.w2 + p.b2


def masked_q(p: QParams, obs, n_ph):
    """Q-values with each intersection's invalid-phase actions at -inf
    (n_ph: (I,) phases per intersection, at least one action each)."""
    q = q_values(p, obs)                                      # (..., I, A)
    a_ids = torch.arange(q.shape[-1], device=q.device)
    mask = a_ids[None, :] < torch.clamp_min(n_ph, 1)[:, None]
    return torch.where(mask, q, -torch.inf)


def huber_loss(pred, target, delta: float = 1.0):
    """optax.huber_loss: 0.5 min(|e|, d)^2 + d (|e| - min(|e|, d))."""
    abs_e = (pred - target).abs()
    quad = torch.clamp_max(abs_e, delta)
    return 0.5 * quad * quad + delta * (abs_e - quad)


def td_loss(p, target, obs, actions, rewards, obs_next, n_ph, gamma):
    """Double-DQN Huber TD(0) over a (B, I, obs) batch: the online net
    picks the next action, the target net rates it."""
    q = q_values(p, obs)                                      # (B, I, A)
    qa = torch.gather(q, -1, actions.long()[..., None])[..., 0]
    with torch.no_grad():
        a_next = torch.argmax(masked_q(p, obs_next, n_ph), dim=-1)
        q_next = torch.gather(q_values(target, obs_next), -1,
                              a_next[..., None])[..., 0]
    target_v = rewards + gamma * q_next
    return huber_loss(qa, target_v).mean()


def eps_greedy(params, obs, n_ph, gen, eps):
    """(B, I) int32 eps-greedy actions from masked Q-values; the draws come
    from `gen` (a torch.Generator on the obs device), so they match the
    JAX learner's only at eps = 0."""
    with torch.no_grad():
        greedy = torch.argmax(masked_q(params, obs, n_ph), dim=-1)
    rand = torch.randint(0, 1 << 30, greedy.shape, generator=gen,
                         device=obs.device) % torch.clamp_min(n_ph, 1)[None]
    explore = torch.rand(greedy.shape, generator=gen, device=obs.device) \
        < eps
    return torch.where(explore, rand, greedy).to(torch.int32)


def clip_by_global_norm(grads, max_norm: float = MAX_NORM):
    """optax.clip_by_global_norm: every gradient times max_norm / |g| when
    the global norm |g| is at least max_norm, as (g / |g|) * max_norm;
    unchanged below it (torch.nn.utils.clip_grad_norm_ divides by
    |g| + 1e-6 instead)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = g_norm >= max_norm
    return [torch.where(clip, (g / g_norm) * max_norm, g) for g in grads]


def apply_update(params, opt, grads):
    """One optax.chain(clip_by_global_norm(5), adam(lr)) step: clip, then
    torch.optim.Adam on the parameters in place."""
    for p, g in zip(params, clip_by_global_norm(grads)):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def phase_one_hot(phase, max_phases: int):
    """jax.nn.one_hot(phase, P) as float32: all zeros for a phase outside
    [0, P) (F.one_hot would raise)."""
    return (phase[..., None] == torch.arange(
        max_phases, device=phase.device)).to(torch.float32)


def _features(net_a, cfg, st, max_phases):
    """((..., I, 3P) observation, (..., I) upstream waiting) of a state
    (G13's waiting counts, G14's features mode)."""
    from cityflow_tpu_torch.core.observe import (
        lane_waiting_vehicle_count, phase_scores)
    w = lane_waiting_vehicle_count(cfg, st)
    fw, fp, up = phase_scores(w, net_a, max_phases, "features")
    obs = torch.cat([fw / 10.0, fp / 10.0,
                     phase_one_hot(st.phase, max_phases)], dim=-1)
    return obs, up


def build_intersection_obs(net_dev, cfg, max_phases: int):
    """Per-intersection observation builder: for every phase p the total
    waiting on its available upstream lanes and its pressure (upstream
    minus downstream waiting), both / 10, then the current phase one-hot.
    Returns (obs_fn, obs_dim); obs_fn(net_a, st) -> (..., I, 3P)."""
    del net_dev

    def obs_fn(net_a, st):
        return _features(net_a, cfg, st, max_phases)[0]
    return obs_fn, 3 * max_phases


def make_dqn_train_step(net_dev, cfg, max_phases: int, hidden: int = 64,
                        lr: float = 1e-3, gamma: float = 0.9,
                        sim_steps_per_action: int = 5):
    """Returns (init_fn, train_step):
      init_fn(gen) -> (params, opt)
      train_step(net_a, params, target, opt, state_B, spawn_tbl, gen, eps)
        -> (params, opt, state_B, gen, metrics)
    One iteration advances every env by one action interval and applies
    one Double-DQN TD(0) update to the shared Q-MLP against `target` (the
    caller copies params into it every few iterations). state_B is
    donated: the steps write it in place."""
    from cityflow_tpu_torch.core import step as step_mod
    _, obs_dim = build_intersection_obs(net_dev, cfg, max_phases)
    n_phases = net_dev["n_phases"]

    def train_step(net_a, params, target, opt, state, spawn_tbl, gen, eps):
        obs, _ = _features(net_a, cfg, state, max_phases)     # (B, I, F)
        actions = eps_greedy(params, obs, n_phases, gen, eps)
        state = state.replace_fields(phase=actions.contiguous())
        for _ in range(sim_steps_per_action):
            state = step_mod.step(net_a, cfg, state, spawn_tbl, donate=True)
        obs_next, up = _features(net_a, cfg, state, max_phases)
        # reward: minus the upstream waiting of each intersection
        rewards = -up / 10.0
        loss = td_loss(params, target, obs, actions, rewards, obs_next,
                       n_phases, gamma)
        grads = torch.autograd.grad(loss, list(params))
        apply_update(params, opt, grads)
        metrics = dict(loss=loss.detach(), mean_reward=rewards.mean())
        return params, opt, state, gen, metrics

    def init_fn(gen):
        p = init_params(gen, obs_dim, hidden,
                        int(torch.clamp_min(n_phases, 1).max()))
        return p, torch.optim.Adam(list(p), lr=lr)

    return init_fn, train_step


def train(config_path: str, batch: int = 16, iters: int = 20,
          max_vehicles: int = 2048, seed: int = 0, device=None,
          on_iter=None, state=None):
    """The training loop (the JAX package's train, without its mesh): returns
    the metric history [{loss, mean_reward}] of `iters` iterations from
    the scenario's initial state, eps 0.5 * 0.95^i (at least 0.05), the
    target network synced every 10 iterations. on_iter(i, metrics,
    state), when given, runs after each iteration. `state`, when given, is
    the batch to start from instead (a warm-up's, on `device`, from the
    same scenario's spawn sequence; donated: the steps write it in place):
    its env count and pool replace `batch` and `max_vehicles`."""
    from cityflow_tpu_torch.carry import net_tensors
    from cityflow_tpu_torch.compiler.net import compile_scenario
    from cityflow_tpu_torch.compiler.spawn import SpawnGenerator
    from cityflow_tpu_torch.core.state import StepConfig, init_state
    from cityflow_tpu_torch.device import resolve_device
    from cityflow_tpu_torch.parallel.batch import (
        init_batch_state, spawn_table)

    dev = resolve_device(device)
    net = compile_scenario(config_path)
    cfgj = net.host.config
    gen_s = SpawnGenerator(net, int(cfgj["seed"]), float(cfgj["interval"]))
    start = 0 if state is None else int(state.step.max())
    if state is not None:
        batch, max_vehicles = state.active.shape
    gen_s.extend(start + iters * 8 + 16)
    spawn = spawn_table(gen_s, dev)
    cfg = StepConfig(
        interval=float(cfgj["interval"]), num_lanes=net.num_lanes,
        num_drivables=net.num_lanes + net.num_links,
        max_vehicles=max_vehicles, max_spawn_per_step=gen_s.max_per_step,
        k_out=max(net.host.ko, 1), k_cross=max(net.host.kc, 1),
        rl_traffic_light=True, exact=False)
    net_dev = net_tensors(net, torch.float32, dev)
    max_phases = int(net.n_phases.max()) if net.n_phases.size else 1
    init_fn, train_step = make_dqn_train_step(net_dev, cfg, max_phases)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, opt = init_fn(gen)
    target = params
    if state is None:
        st0 = init_state(cfg, net.num_inters, net.phase_time, net.n_phases,
                         net.phase_offset, dev)
        state = init_batch_state(cfg, st0, batch)
    history = []
    eps = 0.5
    target_sync = 10
    for i in range(iters):
        if i % target_sync == 0:
            target = copy_params(params)
        params, opt, state, gen, m = train_step(
            net_dev, params, target, opt, state, spawn, gen,
            max(eps * (0.95 ** i), 0.05))
        if on_iter is not None:
            on_iter(i, m, state)
        history.append({k: float(v) for k, v in m.items()})
    return history
