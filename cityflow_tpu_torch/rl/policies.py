"""Signal-control policies on the device (the JAX package's
rl/policies.py).

MaxPressure (Varaiya 2013): per intersection, the phase whose available
lanelinks carry the most total pressure (upstream waiting minus downstream
waiting), the first such phase on a tie. For a batch's state (outputs
lead with the env axis B); the sums and the choice run in
G14 (kernels/phase_scores.py) on G13's waiting counts.
"""

from cityflow_tpu_torch.core.observe import (
    lane_waiting_vehicle_count, phase_scores)
from cityflow_tpu_torch.core.state import SimState, StepConfig


def phase_pressures(net, cfg: StepConfig, st: SimState, max_phases: int):
    """(B, TP) float32 pressure of every (intersection, phase) row."""
    return phase_scores(lane_waiting_vehicle_count(cfg, st), net,
                        max_phases, "phases")[0]


def max_pressure_phases(net, cfg: StepConfig, st: SimState,
                        max_phases: int):
    """(B, I) int32 per-intersection MaxPressure phase: the first phase
    of strictly largest pressure among the intersection's phases (0 for
    an intersection without phases)."""
    return phase_scores(lane_waiting_vehicle_count(cfg, st), net,
                        max_phases, "phases")[1]
