"""RL observations and the MaxPressure controller on the ring layout
(the JAX package's core/ring_observe.py), on trailing-batch state: every
output carries the env axis B last.

The per-lane reductions run in O1 (kernels/lane_stats.py), the
per-intersection phase sums in O2 (kernels/phase_pressure.py). Lane-indexed
outputs are in ring order (lanes grouped by start intersection);
`to_original_lane_order` maps them back to the original lane ids.
"""

import torch

from cityflow_tpu_torch.core.ring import F32, I32, RingConfig, RingState
from cityflow_tpu_torch.kernels.lane_stats import lane_obs, lane_waiting
from cityflow_tpu_torch.kernels.phase_pressure import phase_pressure


def lane_counts_ring(cfg: RingConfig, rs: RingState):
    """(LNp, B) int32 vehicles per lane: the occupancy n_l."""
    return rs.n_l


def lane_waiting_ring(cfg: RingConfig, rs: RingState):
    """(LNp, B) int32 waiting vehicles (speed < 0.1, engine.cpp:641) per
    lane (O1)."""
    return lane_waiting(rs.l_speed, rs.n_l)


def to_original_lane_order(net, x_ring):
    """A (LNp, ...) lane-indexed tensor in original lane order (L, ...)."""
    return x_ring.index_select(0, net["lane_perm"].long())


def phase_pressures(net, cfg: RingConfig, rs: RingState, max_phases: int):
    """(G, P, B) MaxPressure per candidate phase: the sum over the phase's
    available links of (start-lane waiting - end-lane waiting); -inf for a
    phase the intersection does not have (O1, O2)."""
    return phase_pressure(lane_waiting_ring(cfg, rs), net, max_phases,
                          cfg.I)[0]


def phase_features(net, cfg: RingConfig, rs: RingState, max_phases: int):
    """The DQN's observation (O1, O2): (fw, fp, w_up) with fw (G, P, B) the
    waiting on each phase's available upstream lanes, fp (G, P, B) each
    phase's pressure (0 for a phase the intersection does not have), w_up
    (G, B) the upstream waiting of each intersection."""
    return phase_pressure(lane_waiting_ring(cfg, rs), net, max_phases,
                          cfg.I, features=True)


def max_pressure_phases_ring(net, cfg: RingConfig, rs: RingState,
                             max_phases: int):
    """(I, B) int32 MaxPressure phases in ring intersection order: the first
    phase of largest pressure; the trailing virtual intersections get 0."""
    return phase_pressure(lane_waiting_ring(cfg, rs), net, max_phases,
                          cfg.I)[1]


def observations_ring(net, cfg: RingConfig, rs: RingState):
    """lane_count and lane_waiting (LNp, B) int32, and per env
    vehicle_count, current_time and avg_travel_time: (cum_travel + time in
    flight) / max(n, 1) over the n finished and running vehicles, 0 when
    n is 0 (O1)."""
    now = rs.step.to(F32) * net["ring_f32"][len(cfg.params)]
    w, inflight = lane_obs(rs.l_speed, rs.n_l, rs.l_enter, rs.k_enter,
                           rs.n_k, now)
    running = rs.n_l.sum(0, dtype=I32) + rs.n_k.sum(0, dtype=I32)
    n = rs.finished_cnt + running
    return dict(
        lane_count=rs.n_l, lane_waiting=w, vehicle_count=running,
        current_time=now,
        avg_travel_time=torch.where(
            n == 0, 0.0, (rs.cum_travel + inflight) / torch.clamp_min(n, 1)))
