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
    RingConfig, RingState, init_ring_state, ring_step, P_LEN, P_MINGAP)
from cityflow_tpu_torch.device import resolve_device


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


def _build_queues(gen: SpawnGenerator, meta: RingMeta, horizon: int,
                  qcap_round: int = 256):
    """Group the host-replayed spawn rows (mt19937 stream, compiler/spawn.py)
    into per-entry-lane FIFO queues. Row uid = global row index."""
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
    return q


def build_sim(net: CompiledNet, horizon: int = 512,
              sl: Optional[int] = None, skc: Optional[int] = None,
              device=None) -> RingSim:
    """Tables, queues and initial state for `net` on `device` (None means
    "cuda"; pass device="cpu" for the plain PyTorch path on the CPU).

    Branches of the JAX ring step that this port does not cover yet fail
    here rather than simulate something else."""
    dev = resolve_device(device)
    cfgj = net.host.config
    interval = float(cfgj["interval"])
    if cfgj.get("laneChange", False):
        raise NotImplementedError(
            "ring lane change is not ported yet (ROADMAP.md queue 1 item 7, "
            "queue 2 row 15)")
    if str(cfgj.get("routerType", "LENGTH")).upper() == "DURATION":
        raise NotImplementedError(
            "the DURATION router's lane history window is not ported yet "
            "(ROADMAP.md queue 1 item 6, queue 2 row 14)")
    tb, meta = build_ring(net, interval)
    if not meta.supported:
        raise ValueError(f"ring layout unsupported: {meta.unsupported_reason}")
    if not meta.uniform_params:
        raise NotImplementedError(
            "non-uniform vehicle templates are not ported yet "
            "(ROADMAP.md queue 1 item 5)")

    p = meta.param_row
    min_len = float(p[P_LEN]) + float(p[P_MINGAP])
    max_spd = float(p[8])
    params = tuple(float(v) for v in meta.param_row)
    lane_cap = int(np.ceil(np.asarray(tb["ln_len"]).max() / min_len)) + 2
    link_cap = int(np.ceil(np.asarray(tb["lk_len"]).max() / min_len)) + 2
    SL = sl if sl is not None else lane_cap
    SK = link_cap
    xk = max(2, int(np.ceil(max_spd * interval / min_len)))

    cfg = RingConfig(
        interval=interval, I=meta.I, G=meta.G, T=meta.T,
        LPI=meta.LPI, OL=meta.OL, IL=meta.IL, KC=meta.KC,
        KIN=meta.KIN, KOUT=meta.KOUT, LNp=meta.LNp, LKp=meta.LKp,
        SL=SL, SK=SK, AP=max(2, xk), XK=xk, SA=4,
        type_ranges=meta.type_ranges,
        params=params,
        rl_traffic_light=bool(cfgj["rlTrafficLight"]),
        SKC=(skc if skc is not None else 4),
        MAXLPR=int(np.asarray(tb["route_next"]).shape[2]))

    gen = SpawnGenerator(net, int(cfgj["seed"]), interval)
    q = _build_queues(gen, meta, horizon)
    st = init_ring_state(cfg, tb, len(meta.entry_lanes), dev)
    tables = tables_from_numpy(tb, dev, cfg)
    qd = {k: torch.as_tensor(v, device=dev) for k, v in q.items()}
    return RingSim(net=net, meta=meta, cfg=cfg, tables=tables, q=qd,
                   state=st, gen=gen, device=dev)


def step(sim: RingSim):
    """Advance the single-env state by one step."""
    sim.state = ring_step(sim.tables, sim.cfg, sim.state, sim.q)
    return sim.state
