"""Simulation state and static configuration of the gen-1 step, and the
constants the ring step shares with it (the JAX package's core/state.py
keeps the same values).

The gen-1 state is one dataclass of fixed-shape tensors (`SimState`).
Vehicles live in a slot pool of capacity `cfg.max_vehicles`; a slot is
`active` from spawn (waiting buffer) until removal, `running` once admitted
onto its first lane (reference Engine::handleWaiting, engine.cpp:502-516).
Scalars are 0-dim tensors on the state's device, so a step never reads
one back to the host.
"""

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

INT_MAX = 2**31 - 1

# overflow bit flags
OV_SLOTS = 1        # a ring (or the vehicle pool) is full
OV_LINK_TABLE = 2   # more vehicles on one lanelink than its ring / table holds
OV_HOPS = 4         # a vehicle crossed more drivables in a step than bounded
OV_REMOVE = 8       # more removals / transfers in one step than bounded

# SimState's fields in the JAX package's leaf order (archives keep it)
SIM_FIELDS = (
    "step", "seq_counter", "spawn_cursor", "finished_cnt", "cum_travel",
    "overflow",
    "active", "running", "dis", "speed", "drv", "prev_drv", "route",
    "route_pos", "enter_time", "enter_ll_time", "priority", "leader", "gap",
    "blocker", "custom_speed", "has_custom", "list_seq", "uid", "params",
    "partner", "is_shadow", "offset", "lc_changing", "lc_finished",
    "lc_last_t", "lc_target", "lc_has_signal", "lc_dir", "lc_recv",
    "lc_tleader", "lc_tfollower", "lc_lgap", "lc_fgap", "lc_last_dir",
    "phase", "phase_remain",
    "last_of_drv",
    "hist_ring_num", "hist_ring_ssum", "hist_num", "hist_ssum", "hist_t")
SIM_BOOL = frozenset({"active", "running", "has_custom", "is_shadow",
                      "lc_changing", "lc_finished", "lc_has_signal"})
SIM_FLOAT = frozenset({"cum_travel", "dis", "speed", "enter_time", "gap",
                       "custom_speed", "params", "offset", "lc_last_t",
                       "lc_lgap", "lc_fgap", "phase_remain",
                       "hist_ring_num", "hist_ring_ssum", "hist_num",
                       "hist_ssum"})
# per-slot fields (leading axis V) with the value a new empty slot holds
SLOT_FILL = {
    "active": False, "running": False, "dis": 0, "speed": 0, "drv": -1,
    "prev_drv": -1, "route": 0, "route_pos": 0, "enter_time": 0,
    "enter_ll_time": INT_MAX, "priority": 0, "leader": -1, "gap": 0,
    "blocker": -1, "custom_speed": 0, "has_custom": False, "list_seq": 0,
    "uid": -1, "params": 0, "partner": -1, "is_shadow": False, "offset": 0,
    "lc_changing": False, "lc_finished": False, "lc_last_t": 0,
    "lc_target": -1, "lc_has_signal": False, "lc_dir": 0, "lc_recv": -1,
    "lc_tleader": -1, "lc_tfollower": -1, "lc_lgap": 0, "lc_fgap": 0,
    "lc_last_dir": 0}


@dataclass
class SimState:
    # scalars (0-dim)
    step: Any                 # i32 current engine step
    seq_counter: Any          # i32 monotonically increasing list-order ticket
    spawn_cursor: Any         # i32 rows of the spawn table consumed
    finished_cnt: Any         # i32 vehicles that completed their route
    cum_travel: Any           # f   cumulative travel time of finished vehicles
    overflow: Any             # i32 bitmask of capacity-violation flags

    # per-slot (V,)
    active: Any               # bool in pool (waiting or running)
    running: Any              # bool on a drivable
    dis: Any                  # f   distance along current drivable
    speed: Any                # f
    drv: Any                  # i32 current drivable (-1 none)
    prev_drv: Any             # i32
    route: Any                # i32 route id
    route_pos: Any            # i32 index of current road within route
    enter_time: Any           # f
    enter_ll_time: Any        # i32 (INT_MAX when not on a lanelink)
    priority: Any             # i32 (mt19937 draw; pool iteration order)
    leader: Any               # i32 slot of leader (-1)
    gap: Any                  # f
    blocker: Any              # i32 slot of blocking vehicle at a cross (-1)
    custom_speed: Any         # f   set_vehicle_speed buffer (one step)
    has_custom: Any           # bool
    list_seq: Any             # i32 order-within-drivable ticket
    uid: Any                  # i32 global spawn uid (-1 free slot)
    params: Any               # (V, 12) f vehicle params (compiler/net P_*)

    # lane change (core/lanechange.py): the real / shadow pair, the
    # lateral offset, this step's signal, target and gaps
    partner: Any
    is_shadow: Any
    offset: Any
    lc_changing: Any
    lc_finished: Any
    lc_last_t: Any
    lc_target: Any
    lc_has_signal: Any
    lc_dir: Any
    lc_recv: Any
    lc_tleader: Any
    lc_tfollower: Any
    lc_lgap: Any
    lc_fgap: Any
    lc_last_dir: Any

    # lights (I,)
    phase: Any                # i32
    phase_remain: Any         # f

    # rear vehicle per drivable at the end of the previous step, read by
    # handleWaiting's admission before this step's arrangement
    last_of_drv: Any          # (D,) i32

    # DURATION lane history (Lane::updateHistory): (HL + 1, L) ring rows,
    # (L,) window sums, the calls so far; (1, 1) / (1,) dummies without it
    hist_ring_num: Any
    hist_ring_ssum: Any
    hist_num: Any
    hist_ssum: Any
    hist_t: Any

    def replace_fields(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    def leaves(self):
        return {k: getattr(self, k) for k in SIM_FIELDS}

    def map(self, fn) -> "SimState":
        return SimState(**{k: fn(v) for k, v in self.leaves().items()})


@dataclass(frozen=True)
class StepConfig:
    """Static configuration of the gen-1 step (the JAX package's
    StepConfig, field for field)."""
    interval: float
    num_lanes: int
    num_drivables: int
    max_vehicles: int = 4096
    max_spawn_per_step: int = 16
    k_link: int = 16          # dense per-lanelink vehicle table width
    k_out: int = 8            # max outgoing lanelinks per lane
    k_cross: int = 32         # max crosses per lanelink
    k_scan: int = 6           # leader-scan drivable lookahead
    k_hop: int = 4            # max drivables crossed per step
    k_chase: int = 6          # fast-mode deadlock-walk cap (2**k_chase steps)
    k_phase: int = 8          # light phase advances per step
    max_remove: int = 16      # ordered-sum buffer for finish stats (grows)
    rl_traffic_light: bool = False
    lane_change: bool = False
    exact: bool = True        # f64 + ordered reductions (golden parity)
    track_history: bool = False
    history_len: int = 240

    @property
    def dtype(self):
        return torch.float64 if self.exact else torch.float32


def init_state(cfg: StepConfig, num_inters: int, phase_time0: np.ndarray,
               n_phases: np.ndarray, phase_offset: np.ndarray,
               device) -> SimState:
    V = cfg.max_vehicles
    f = cfg.dtype
    dev = torch.device(device)
    zf = lambda *s: torch.zeros(s, dtype=f, device=dev)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    fi = lambda v, *s: torch.full(s, v, dtype=torch.int32, device=dev)
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)

    # TrafficLight::init(0): remainDuration = phases[0].time
    # (trafficlight.cpp:6-11)
    off = np.clip(phase_offset, 0, len(phase_time0) - 1)
    first_time = phase_time0[off]
    remain = torch.as_tensor(np.where(n_phases > 0, first_time, 0.0),
                             dtype=f, device=dev)
    # the DURATION router's window: (HL + 1, L) ring rows and (L,) sums,
    # (1, 1) / (1,) dummies without it
    HL1, L = ((cfg.history_len + 1, cfg.num_lanes) if cfg.track_history
              else (1, 1))
    return SimState(
        step=zi(), seq_counter=zi(), spawn_cursor=zi(), finished_cnt=zi(),
        cum_travel=zf(), overflow=zi(),
        active=zb(V), running=zb(V), dis=zf(V), speed=zf(V),
        drv=fi(-1, V), prev_drv=fi(-1, V), route=zi(V), route_pos=zi(V),
        enter_time=zf(V), enter_ll_time=fi(INT_MAX, V), priority=zi(V),
        leader=fi(-1, V), gap=zf(V), blocker=fi(-1, V),
        custom_speed=zf(V), has_custom=zb(V), list_seq=zi(V),
        uid=fi(-1, V), params=zf(V, 12),
        partner=fi(-1, V), is_shadow=zb(V), offset=zf(V),
        lc_changing=zb(V), lc_finished=zb(V), lc_last_t=zf(V),
        lc_target=fi(-1, V), lc_has_signal=zb(V), lc_dir=zi(V),
        lc_recv=fi(-1, V), lc_tleader=fi(-1, V), lc_tfollower=fi(-1, V),
        lc_lgap=zf(V), lc_fgap=zf(V), lc_last_dir=zi(V),
        phase=zi(num_inters), phase_remain=remain,
        last_of_drv=fi(-1, cfg.num_drivables),
        hist_ring_num=zf(HL1, L), hist_ring_ssum=zf(HL1, L),
        hist_num=zf(L), hist_ssum=zf(L), hist_t=zi())


def pad_state(st: SimState, new_v: int) -> SimState:
    """Grow the slot pool to `new_v` slots, the new ones empty (a new
    state: the caller may still step the old one)."""
    old_v = st.active.shape[0]
    if new_v == old_v:
        return st

    def grow(k, a):
        if k not in SLOT_FILL:
            return a
        extra = torch.full((new_v - old_v,) + tuple(a.shape[1:]),
                           SLOT_FILL[k], dtype=a.dtype, device=a.device)
        return torch.cat([a, extra], dim=0)
    return SimState(**{k: grow(k, v) for k, v in st.leaves().items()})
