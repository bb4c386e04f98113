"""Vectorized signal-control envs (the JAX package's rl/env.py): B envs of
one scenario step together on the device, actions set every
intersection's phase, and the lights are under the caller's control
(rlTrafficLight on, whatever the config says).

CityFlowVecEnv runs the gen-1 slot-pool step in fast mode (float32) with a
leading env axis (parallel/batch.py), on any net; its observations come
from core/observe.py (G13, G14). RingVecEnv runs the ring layout
(trailing-batch, core/ring.py) on grid nets, its observations from
core/ring_observe.py (O1, O2).
"""

import dataclasses

import numpy as np
import torch

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.carry import net_tensors
from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.compiler.spawn import SpawnGenerator
from cityflow_tpu_torch.core import observe
from cityflow_tpu_torch.core import ring_observe
from cityflow_tpu_torch.core import step as step_mod
from cityflow_tpu_torch.core.ring import (
    I32, batch_ring_state, ring_step_p1_batched, ring_step_p2_batched)
from cityflow_tpu_torch.core.state import StepConfig, init_state
from cityflow_tpu_torch.device import resolve_device
from cityflow_tpu_torch.parallel.batch import init_batch_state, spawn_table
from cityflow_tpu_torch.rl.policies import max_pressure_phases


def gen1_k_link(net):
    """The per-lanelink vehicle table width the JAX env and bench give the
    gen-1 step: room for a lanelink's length at 7 m a vehicle, plus 2,
    at most 16 (4 in a net with no lanelinks)."""
    if not net.num_links:
        return 4
    L = net.num_lanes
    return int(min(16, np.ceil(net.drv_len[L:].max() / 7.0) + 2))


class CityFlowVecEnv:
    """Gym-style batched env on the gen-1 step: actions are (B, I) phase
    indices, observations a dict of (B, ...) tensors (core/observe.py),
    the reward (B,) minus the number of waiting vehicles.

    `device` is where the env lives: None means the card (and raises
    without one), "cpu" the plain PyTorch path."""

    def __init__(self, config_path: str, batch: int = 64,
                 max_vehicles: int = 4096, horizon: int = 4096,
                 action_interval: int = 1, device=None):
        self.device = resolve_device(device)
        self.net = compile_scenario(config_path)
        cfgj = self.net.host.config
        self.interval = float(cfgj["interval"])
        self.batch = batch
        self.action_interval = action_interval
        gen = SpawnGenerator(self.net, int(cfgj["seed"]), self.interval)
        gen.extend(horizon)
        self._spawn = spawn_table(gen, self.device)
        L = self.net.num_lanes
        self.cfg = StepConfig(
            interval=self.interval, num_lanes=L,
            num_drivables=L + self.net.num_links,
            max_vehicles=max_vehicles, max_spawn_per_step=gen.max_per_step,
            k_link=gen1_k_link(self.net), k_out=max(self.net.host.ko, 1),
            k_cross=max(self.net.host.kc, 1),
            rl_traffic_light=True, exact=False)
        self._net_dev = net_tensors(self.net, torch.float32, self.device)
        self._st0 = init_state(self.cfg, self.net.num_inters,
                               self.net.phase_time, self.net.n_phases,
                               self.net.phase_offset, self.device)
        self.num_intersections = self.net.num_inters
        self.num_phases = self.net.n_phases  # (I,) per intersection
        self._max_phases = int(self.net.n_phases.max()) \
            if self.net.n_phases.size else 1
        self.state = None

    def reset(self):
        """Every env back to the scenario's initial state (contiguous
        copies); returns the observations."""
        self.state = init_batch_state(self.cfg, self._st0, self.batch)
        return observe.observations(self._net_dev, self.cfg, self.state)

    def step(self, phases):
        """phases: (B, I) int -> (obs dict, reward (B,)): the phases held
        for action_interval steps. The step writes the previous self.state
        in place (donated, as the JAX package's batched entries donate
        it)."""
        phases = torch.as_tensor(phases, device=self.device)
        st = self.state.replace_fields(
            phase=phases.to(torch.int32).contiguous())
        for _ in range(self.action_interval):
            st = step_mod.step(self._net_dev, self.cfg, st, self._spawn,
                               donate=True)
        self.state = st
        obs = observe.observations(self._net_dev, self.cfg, st)
        reward = -obs["lane_waiting"].to(torch.float32).sum(-1)
        return obs, reward

    def max_pressure_actions(self):
        """(B, I) int32 MaxPressure phases for the current state, on the
        device."""
        return max_pressure_phases(self._net_dev, self.cfg, self.state,
                                   self._max_phases)


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
        reward (B,)). The step writes the previous self.state in place (as
        JAX's batched entries donate it)."""
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
