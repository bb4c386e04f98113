"""Batched gen-1 simulation: B env instances of one scenario in lockstep
(the JAX package's parallel/batch.py).

The JAX package vmaps the pure single-env step over the env axis. The port
has the env axis in the step itself: every per-slot SimState leaf is
(B, V), the per-env scalars (B,), the lights (B, I), and each kernel
launches once over all envs with the env on its grid (core/step.py). The
net tables and the spawn table are shared by every env (JAX's
in_axes=None). No host read-back inside a step or a rollout.

The batched entries donate the state they are given (the JAX package's
make_rollout donates it, donate_argnums): the step writes its leaves and
history rings in place (core/step.step, donate=True), so a caller drops
the state it hands over, or hands over a copy to keep it.
init_batch_state makes contiguous copies of one env's state.

The JAX package's make_sharded_step (the env axis over a device mesh) is
not ported yet (ROADMAP.md, multi-device).
"""

import numpy as np
import torch

from cityflow_tpu_torch.core import observe
from cityflow_tpu_torch.core import step as step_mod
from cityflow_tpu_torch.core.state import SimState, StepConfig


SPAWN_ROWS = ("step", "flow", "priority", "first_drv", "route")


def spawn_table(gen, device):
    """A SpawnGenerator's rows so far as the step's spawn table on
    `device`: (n,) int32 columns, padded with max_per_step rows that never
    spawn (step -1), so a window of max_spawn_per_step rows always fits."""
    t = gen.arrays()
    pad = max(gen.max_per_step, 1)
    return {k: torch.as_tensor(np.concatenate(
        [t[k], np.full(pad, -1 if k == "step" else 0, t[k].dtype)]),
        device=device) for k in SPAWN_ROWS}


def init_batch_state(cfg: StepConfig, base_state: SimState,
                     batch: int) -> SimState:
    """Replicate one env's state across a leading env axis of `batch`:
    contiguous copies (never broadcast views, so no env aliases
    another)."""
    del cfg
    return base_state.map(
        lambda x: x[None].repeat((batch,) + (1,) * x.dim()).contiguous())


def make_batched_step(net, cfg: StepConfig, with_obs: bool = True,
                      rl_actions: bool = False):
    """Returns step_b(state_B, spawn_tbl[, phases]) -> (state_B, obs_B or
    None): one step of every env, state_B donated (written in place). With
    rl_actions, phases (B, I) set each env's lights first; otherwise
    phases, when given, are (I,) and set every env's."""

    def step_b(state, spawn_tbl, phases=None):
        if phases is not None:
            phases = torch.as_tensor(phases, device=state.phase.device)
            if not rl_actions:
                phases = phases.expand(state.phase.shape)
            state = state.replace_fields(
                phase=phases.to(torch.int32).contiguous())
        state = step_mod.step(net, cfg, state, spawn_tbl, donate=True)
        if with_obs:
            return state, observe.observations(net, cfg, state)
        return state, None

    return step_b


def make_rollout(net, cfg: StepConfig, n_steps: int):
    """rollout(state_B, spawn_tbl) -> state_B after n_steps batched steps,
    queued on the device without a host read-back (the JAX package scans
    them in one program); state_B donated, as JAX's rollout donates it."""

    def rollout(state, spawn_tbl):
        for _ in range(n_steps):
            state = step_mod.step(net, cfg, state, spawn_tbl, donate=True)
        return state

    return rollout
