"""DQN signal-control learner on the ring layout (the JAX package's
rl/ring_dqn.py): a parameter-tied per-intersection Q-MLP (rl/dqn.py),
Double-DQN TD(0) with a Huber loss, eps-greedy actions, Adam after a
global-norm clip; the env inside an iteration is the batched ring step and
the observations come from core/ring_observe.phase_features (O1, O2).

Actions are (B, G) phase indices over the ring's real intersections (ring
order); the state's phase vector is (I, B) with the trailing virtual
intersections held at phase 0. The env state is trailing-batch; the learner
tensors (obs, actions, Q) lead with B.

Where the JAX learner takes a jax.random key and an optax state, this one
takes a torch.Generator and a torch.optim.Adam; the parameters are updated
in place, and the target network is a copy (dqn.copy_params).
"""

import torch

from cityflow_tpu_torch.core import ring_observe
from cityflow_tpu_torch.core.ring import (
    I32, ring_step_p1_batched, ring_step_p2_batched)
from cityflow_tpu_torch.rl.dqn import init_params, q_values

MAX_NORM = 5.0


def build_ring_intersection_obs(cfg, max_phases: int):
    """obs_fn(tables, rs) -> ((B, G, 3P) features, (B, G) upstream
    waiting) on trailing-batch state."""
    def obs_fn(tables, rs):
        fw, fp, w_up = ring_observe.phase_features(tables, cfg, rs,
                                                   max_phases)
        # jax.nn.one_hot: all zeros for a phase outside [0, P)
        ph = rs.phase[:cfg.G].T                               # (B, G)
        phase_1h = (ph[..., None] == torch.arange(
            max_phases, device=ph.device)).to(torch.float32)
        obs = torch.cat([fw.permute(2, 0, 1) / 10.0,
                         fp.permute(2, 0, 1) / 10.0, phase_1h], dim=-1)
        return obs, w_up.T
    return obs_fn, 3 * max_phases


def _masked_q(p, obs, n_ph):
    """Q-values with each intersection's invalid-phase actions at -inf."""
    q = q_values(p, obs)                                      # (..., G, A)
    a_ids = torch.arange(q.shape[-1], device=q.device)
    mask = a_ids[None, :] < torch.clamp_min(n_ph, 1)[:, None]
    return torch.where(mask, q, -torch.inf)


def huber_loss(pred, target, delta: float = 1.0):
    """optax.huber_loss: 0.5 min(|e|, d)^2 + d (|e| - min(|e|, d))."""
    abs_e = (pred - target).abs()
    quad = torch.clamp_max(abs_e, delta)
    return 0.5 * quad * quad + delta * (abs_e - quad)


def _td_loss(p, target, obs, actions, rewards, obs_next, n_ph, gamma):
    """Double-DQN Huber TD(0) over a (B, G, obs) batch: the online net
    picks the next action, the target net rates it."""
    q = q_values(p, obs)                                      # (B, G, A)
    qa = torch.gather(q, -1, actions.long()[..., None])[..., 0]
    with torch.no_grad():
        a_next = torch.argmax(_masked_q(p, obs_next, n_ph), dim=-1)
        q_next = torch.gather(q_values(target, obs_next), -1,
                              a_next[..., None])[..., 0]
    target_v = rewards + gamma * q_next
    return huber_loss(qa, target_v).mean()


def _eps_greedy(tables, params, obs, gen, eps):
    """(B, G) int32 eps-greedy actions from masked Q-values; the draws come
    from `gen` (a torch.Generator on the obs device)."""
    n_ph = tables["g_n_phases"]
    with torch.no_grad():
        greedy = torch.argmax(_masked_q(params, obs, n_ph), dim=-1)
    rand = torch.randint(0, 1 << 30, greedy.shape, generator=gen,
                         device=obs.device) % torch.clamp_min(n_ph, 1)[None]
    explore = torch.rand(greedy.shape, generator=gen, device=obs.device) \
        < eps
    return torch.where(explore, rand, greedy).to(I32)


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


def make_ring_dqn_split_step(tables, cfg, max_phases: int,
                             hidden: int = 64, lr: float = 1e-3,
                             gamma: float = 0.9,
                             sim_steps_per_action: int = 5):
    """Returns (init_fn, train_iter):
      init_fn(gen, max_actions) -> (params, opt)
      train_iter(tables, params, target, opt, state, q, gen, eps)
        -> (params, opt, state, gen, metrics)
    One iteration: observations and eps-greedy actions on `state`
    (trailing-batch), sim_steps_per_action batched ring steps with those
    phases held, then one TD update of `params` against `target`. The
    caller copies params into target every few iterations."""
    obs_fn, obs_dim = build_ring_intersection_obs(cfg, max_phases)
    G, I = cfg.G, cfg.I

    def train_iter(tables_a, params, target, opt, state, q, gen, eps):
        obs, _ = obs_fn(tables_a, state)
        actions = _eps_greedy(tables_a, params, obs, gen, eps)
        B = actions.shape[0]
        phases = torch.cat([actions, torch.zeros(
            (B, I - G), dtype=I32, device=actions.device)], dim=1)
        state = state.replace_fields(phase=phases.T.contiguous())
        for _ in range(sim_steps_per_action):
            state, mid = ring_step_p1_batched(tables_a, cfg, state, q)
            state = ring_step_p2_batched(tables_a, cfg, state, mid)
        obs_next, w_up_next = obs_fn(tables_a, state)
        rewards = -w_up_next / 10.0                           # (B, G)
        loss = _td_loss(params, target, obs, actions, rewards, obs_next,
                        tables_a["g_n_phases"], gamma)
        grads = torch.autograd.grad(loss, list(params))
        apply_update(params, opt, grads)
        metrics = dict(loss=loss.detach(), mean_reward=rewards.mean())
        return params, opt, state, gen, metrics

    def init_fn(gen, max_actions: int):
        p = init_params(gen, obs_dim, hidden, max_actions)
        return p, torch.optim.Adam(list(p), lr=lr)

    return init_fn, train_iter


# The JAX package's make_ring_dqn_train_step compiles the same iteration as
# one XLA program on leading-batch state; eager PyTorch has no such program
# to build, so here it is the split iteration under that name
# (trailing-batch state).
make_ring_dqn_train_step = make_ring_dqn_split_step
