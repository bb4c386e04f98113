"""Vectorized signal-control env on the ring layout (the JAX package's
rl/env.py RingVecEnv).

B envs of one scenario step together on the device in the trailing-batch
layout (core/ring.py); actions set every intersection's phase, and the
observations come from core/ring_observe.py (O1, O2). The lights are under
the caller's control (rlTrafficLight on, whatever the config says).
"""

import dataclasses

import numpy as np
import torch

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.core import ring_observe
from cityflow_tpu_torch.core.ring import (
    I32, batch_ring_state, ring_step_p1_batched, ring_step_p2_batched)


class RingVecEnv:
    """Gym-style batched env: actions are (B, I) phase indices in ORIGINAL
    intersection order; observations are a dict of (B, ...) tensors, the
    lane-indexed ones in original lane order; the reward (B,) is minus the
    number of waiting vehicles.

    `device` is where the env lives: None means the card (and raises
    without one), "cpu" the plain PyTorch path."""

    def __init__(self, config_path: str, batch: int = 64,
                 horizon: int = 4096, lane_slots=None, device=None):
        self.net = compile_scenario(config_path)
        sim = ring_sim.build_sim(self.net, horizon=horizon, sl=lane_slots,
                                 device=device)
        sim.cfg = dataclasses.replace(sim.cfg, rl_traffic_light=True)
        self.sim = sim
        self.device = sim.device
        self.batch = batch
        self.num_intersections = self.net.num_inters
        self.num_phases = self.net.n_phases
        self._max_phases = int(self.net.n_phases.max()) \
            if self.net.n_phases.size else 1
        ring2orig = np.asarray(sim.meta.new2old_inter, np.int64)
        orig2ring = np.zeros(sim.meta.I, np.int64)
        orig2ring[ring2orig] = np.arange(sim.meta.I)
        self._i_ring2orig = torch.as_tensor(ring2orig, device=self.device)
        self._i_orig2ring = torch.as_tensor(orig2ring, device=self.device)
        self.state = None

    def reset(self):
        """Every env back to the scenario's initial state."""
        self.state = batch_ring_state(self.sim.state, self.batch)
        return None

    def step(self, phases):
        """phases: (B, I) int in original intersection order -> (obs dict,
        reward (B,))."""
        sim = self.sim
        phases = torch.as_tensor(phases, device=self.device)
        ring_phase = phases.index_select(1, self._i_ring2orig).to(I32)
        st = self.state.replace_fields(phase=ring_phase.T.contiguous())
        st, mid = ring_step_p1_batched(sim.tables, sim.cfg, st, sim.q)
        self.state = ring_step_p2_batched(sim.tables, sim.cfg, st, mid)
        obs = ring_observe.observations_ring(sim.tables, sim.cfg, self.state)
        out = dict(obs)                  # per env: (B,) already
        for k in ("lane_count", "lane_waiting"):
            out[k] = ring_observe.to_original_lane_order(
                sim.tables, obs[k]).T.contiguous()
        reward = -out["lane_waiting"].to(torch.float32).sum(1)
        return out, reward

    def max_pressure_actions(self):
        """(B, I) int32 MaxPressure phases for the current state, in
        original intersection order."""
        ring = ring_observe.max_pressure_phases_ring(
            self.sim.tables, self.sim.cfg, self.state, self._max_phases)
        return ring.index_select(0, self._i_orig2ring).T.contiguous()
