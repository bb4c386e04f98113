"""RL observations of the gen-1 step on the device (the JAX package's
core/observe.py), for a batch's state (every output carries the leading
env axis B; one env is a batch of one, core/step.lift).

The per-lane and per-env reductions over the slot pool run in G13
(kernels/lane_counts.py), the per-intersection sums in G14
(kernels/phase_scores.py).
"""

import torch

from cityflow_tpu_torch.core.state import SimState, StepConfig
from cityflow_tpu_torch.core.step import _kernel


def phase_scores(w, net, max_phases, mode):
    """G14 (looked up at call time, like the step's kernels)."""
    return _kernel("phase_scores")(w, net, max_phases, mode)


def _counts(cfg: StepConfig, st: SimState, interval=None, drivables=False):
    """G13 on a state; with the 0-dim interval also the per-env sums."""
    return _kernel("lane_counts")(
        st.running, st.active, st.drv, st.speed, st.enter_time, st.step,
        interval, cfg.num_lanes, cfg.num_drivables if drivables else None)


def lane_vehicle_count(cfg: StepConfig, st: SimState):
    """(B, L) int32: Engine::getLaneVehicleCount (engine.cpp:628-634)."""
    return _counts(cfg, st)["lane_count"]


def lane_waiting_vehicle_count(cfg: StepConfig, st: SimState):
    """(B, L) int32: speed < 0.1 => waiting (engine.cpp:636-648)."""
    return _counts(cfg, st)["lane_waiting"]


def drivable_vehicle_count(cfg: StepConfig, st: SimState):
    """(B, D) int32: counts on lanes and lanelinks."""
    return _counts(cfg, st, drivables=True)["drivable_count"]


def intersection_pressure(net, cfg: StepConfig, st: SimState):
    """(B, I) float32: per intersection the sum over its lanelinks of
    start-lane waiting minus end-lane waiting."""
    return phase_scores(lane_waiting_vehicle_count(cfg, st), net, 1,
                        "pressure")


def observations(net, cfg: StepConfig, st: SimState) -> dict:
    """The standard RL observation bundle, all on the device: lane_count,
    lane_waiting (B, L), pressure (B, I), and per env vehicle_count,
    current_time and avg_travel_time."""
    c = _counts(cfg, st, net["interval"])
    return dict(
        lane_count=c["lane_count"],
        lane_waiting=c["lane_waiting"],
        pressure=phase_scores(c["lane_waiting"], net, 1, "pressure"),
        vehicle_count=c["running"],
        current_time=st.step.to(torch.float32) * cfg.interval,
        avg_travel_time=_travel_time_of(st, c))


def _avg_travel_time(cfg: StepConfig, st: SimState):
    """Engine::getAverageTravelTime (engine.cpp:682-691) with an unordered
    in-flight sum (the fast path; the exact Engine sums on the host in pool
    order). observations() computes it with the other sums."""
    interval = torch.tensor(cfg.interval, dtype=st.dis.dtype,
                            device=st.dis.device)
    return _travel_time_of(st, _counts(cfg, st, interval))


def _travel_time_of(st: SimState, c):
    n = st.finished_cnt + c["active"]
    tt = st.cum_travel + c["inflight"]
    return torch.where(n == 0, 0.0, tt / torch.clamp_min(n, 1))
