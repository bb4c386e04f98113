"""Host side of the PyTorch ring simulator: builds the device tables,
the spawn queues and the initial state, and steps one env."""

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from cityflow_tpu_torch.carry import tables_from_numpy
from cityflow_tpu_torch.compiler.net import CompiledNet
from cityflow_tpu_torch.compiler.ring_net import build_ring, RingMeta
from cityflow_tpu_torch.compiler.spawn import SpawnGenerator
from cityflow_tpu_torch.core.ring import (
    RingConfig, RingState, init_ring_state, ring_step, P_LEN, P_MAXSPEED,
    P_MINGAP)
from cityflow_tpu_torch.device import resolve_device

# shadow inserts per lane and step for lane change with non-uniform
# templates: the JAX package's 2 is too few there (the mixed 30x30
# lane-change grid flags OV_REMOVE at 2); the most that grid asks of one
# lane in one step, warm-up and window, is 4 (chip_smoke.py [mixed-lc]
# measures it on every run and fails if it passes the cap)
TEMPLATE_LCI = 4


@dataclass
class RingSim:
    net: CompiledNet = None
    meta: RingMeta = None
    cfg: RingConfig = None
    tables: Dict = None          # device tensors
    q: Dict = None               # spawn queues (EL, QCAP) on the device
    state: RingState = None      # one env, no batch axis
    gen: SpawnGenerator = None
    device: object = None


def _flow_tpl_now(net: CompiledNet, tpl_params: np.ndarray) -> np.ndarray:
    """Flow -> template-index map, from the flow_params rows as they are
    now (a flow whose row matches no template maps to 0)."""
    fp = net.flow_params.astype(np.float32)
    eq = np.all(np.isclose(fp[:, None, :], tpl_params[None]), axis=2)
    return np.where(eq.any(1), eq.argmax(1), 0).astype(np.int32)


def _build_queues(gen: SpawnGenerator, meta: RingMeta, horizon: int,
                  qcap_round: int = 256, flow_tpl=None):
    """Group the host-replayed spawn rows (mt19937 stream, compiler/spawn.py)
    into per-entry-lane FIFO queues. Row uid = global row index. With
    `flow_tpl` (non-uniform templates) a "tpl" column holds each row's
    template index."""
    gen.extend(horizon)
    t = gen.arrays()
    EL = len(meta.entry_lanes)
    el_index = {int(p): i for i, p in enumerate(meta.entry_lanes)}
    per = [[] for _ in range(EL)]
    lane_pos = meta.lane_pos
    for r in range(len(t["step"])):
        fd = int(t["first_drv"][r])
        p = int(lane_pos[fd])
        e = el_index.get(p)
        if e is None:
            raise ValueError("spawn row on a lane outside the entry set "
                             "(push_vehicle with a new road needs a rebuild)")
        per[e].append(r)
    qcap = max((len(v) for v in per), default=1) or 1
    qcap = ((qcap + qcap_round - 1) // qcap_round) * qcap_round
    q = {k: np.full((EL, qcap), -1, np.int32)
         for k in ("step", "flow", "pri", "route", "uid")}
    for e, rows in enumerate(per):
        for j, r in enumerate(rows):
            q["step"][e, j] = t["step"][r]
            q["flow"][e, j] = t["flow"][r]
            q["pri"][e, j] = t["priority"][r]
            q["route"][e, j] = t["route"][r]
            q["uid"][e, j] = r
    if flow_tpl is not None:
        q["tpl"] = np.where(
            q["flow"] >= 0,
            flow_tpl[np.clip(q["flow"], 0, len(flow_tpl) - 1)],
            0).astype(np.int32)
    return q


def build_sim(net: CompiledNet, horizon: int = 512,
              sl: Optional[int] = None, skc: Optional[int] = None,
              device=None, sk: Optional[int] = None) -> RingSim:
    """Tables, queues and initial state for `net` on `device` (None means
    "cuda"; pass device="cpu" for the plain PyTorch path on the CPU).
    sl / sk override the lane / link ring slots (default: the longest
    drivable's capacity; with non-uniform templates the capacity of the
    template that packs densest). The shadow inserts per lane per step are
    RingConfig's 2, as in the JAX package's build_sim, but with lane
    change and non-uniform templates the most L3 takes, 8: the mixed
    30x30 lane-change grid sends more than 2 changers into a lane in a
    step. Below the cap its value changes nothing; above it the step
    flags OV_REMOVE."""
    dev = resolve_device(device)
    cfgj = net.host.config
    interval = float(cfgj["interval"])
    lane_change = bool(cfgj.get("laneChange", False))
    tb, meta = build_ring(net, interval)
    if not meta.supported:
        raise ValueError(f"ring layout unsupported: {meta.unsupported_reason}")
    if meta.uniform_params:
        p = meta.param_row
        min_len = float(p[P_LEN]) + float(p[P_MINGAP])
        max_spd = float(p[P_MAXSPEED])
        params = tuple(float(v) for v in meta.param_row)
    else:
        # capacity and exit-hop bounds from the worst-case template; the
        # scalar parameters are NaN, so a use site that misses the per-slot
        # templates yields NaN instead of simulating template 0
        used = np.asarray(tb["tpl_params"])
        if not np.isfinite(used).all():
            # the JAX one-hot einsum turns 0 * inf into NaN where T1 reads
            # the entry: the two agree only on finite parameters
            raise ValueError("vehicle template parameters must be finite")
        min_len = float((used[:, P_LEN] + used[:, P_MINGAP]).min())
        max_spd = float(used[:, P_MAXSPEED].max())
        params = tuple([float("nan")] * 12)
    lane_cap = int(np.ceil(np.asarray(tb["ln_len"]).max() / min_len)) + 2
    link_cap = int(np.ceil(np.asarray(tb["lk_len"]).max() / min_len)) + 2
    SL = sl if sl is not None else lane_cap
    SK = sk if sk is not None else link_cap
    xk = max(2, int(np.ceil(max_spd * interval / min_len)))

    cfg = RingConfig(
        interval=interval, I=meta.I, G=meta.G, T=meta.T,
        LPI=meta.LPI, OL=meta.OL, IL=meta.IL, KC=meta.KC,
        KIN=meta.KIN, KOUT=meta.KOUT, LNp=meta.LNp, LKp=meta.LKp,
        SL=SL, SK=SK, AP=max(2, xk), XK=xk, SA=4,
        type_ranges=meta.type_ranges,
        params=params,
        uniform=bool(meta.uniform_params), TP=int(meta.TP),
        rl_traffic_light=bool(cfgj["rlTrafficLight"]),
        SKC=(skc if skc is not None else 4),
        MAXLPR=int(np.asarray(tb["route_next"]).shape[2]),
        lane_change=lane_change,
        **({} if meta.uniform_params or not lane_change
           else dict(LCI=TEMPLATE_LCI)),
        track_history=(str(cfgj.get("routerType", "LENGTH")).upper()
                       == "DURATION"))

    gen = SpawnGenerator(net, int(cfgj["seed"]), interval)
    q = _build_queues(gen, meta, horizon,
                      flow_tpl=None if cfg.uniform
                      else _flow_tpl_now(net, np.asarray(tb["tpl_params"])))
    st = init_ring_state(cfg, tb, len(meta.entry_lanes), dev)
    tables = tables_from_numpy(tb, dev, cfg)
    qd = {k: torch.as_tensor(v, device=dev) for k, v in q.items()}
    return RingSim(net=net, meta=meta, cfg=cfg, tables=tables, q=qd,
                   state=st, gen=gen, device=dev)


def step(sim: RingSim):
    """Advance the single-env state by one step."""
    sim.state = ring_step(sim.tables, sim.cfg, sim.state, sim.q)
    return sim.state
