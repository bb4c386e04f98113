"""DQN signal-control learner on the ring layout (the JAX package's
rl/ring_dqn.py): a parameter-tied per-intersection Q-MLP, Double-DQN
TD(0) with a Huber loss, eps-greedy actions, Adam after a global-norm clip
(all from rl/dqn.py, shared with the gen-1 learner); the env inside an
iteration is the batched ring step and the observations come from
core/ring_observe.phase_features (O1, O2).

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
from cityflow_tpu_torch.rl.dqn import (
    apply_update, eps_greedy, init_params, phase_one_hot, td_loss)


def build_ring_intersection_obs(cfg, max_phases: int):
    """obs_fn(tables, rs) -> ((B, G, 3P) features, (B, G) upstream
    waiting) on trailing-batch state."""
    def obs_fn(tables, rs):
        fw, fp, w_up = ring_observe.phase_features(tables, cfg, rs,
                                                   max_phases)
        phase_1h = phase_one_hot(rs.phase[:cfg.G].T, max_phases)
        obs = torch.cat([fw.permute(2, 0, 1) / 10.0,
                         fp.permute(2, 0, 1) / 10.0, phase_1h], dim=-1)
        return obs, w_up.T
    return obs_fn, 3 * max_phases


def _eps_greedy(tables, params, obs, gen, eps):
    """(B, G) int32 eps-greedy actions over the ring's real intersections
    (dqn.eps_greedy with the ring's phase counts)."""
    return eps_greedy(params, obs, tables["g_n_phases"], gen, eps)


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
    caller copies params into target every few iterations. The steps
    write `state` in place (the batched ring entries, as JAX's donate
    theirs): pass a state that is not needed afterwards."""
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
        loss = td_loss(params, target, obs, actions, rewards, obs_next,
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
