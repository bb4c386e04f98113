"""Compile a CityFlow scenario (config + roadnet + flow JSON) into dense
numpy tables consumed by the device step function.

Drivable indexing convention: global drivable index d in [0, L) is lane d;
d in [L, L+LL) is lanelink d-L. -1 means "none".

All float tables are float64 here; the simulator casts to its working dtype.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from cityflow_tpu_torch.compiler.roadnet import HostRoadNet
from cityflow_tpu_torch.compiler import flows as flows_mod
from cityflow_tpu_torch.compiler.flows import FlowSpec

INT_MAX = np.int32(2**31 - 1)

# parameter column indices (order matches VehicleTemplate.as_list)
P_SPEED, P_LEN, P_WIDTH, P_MAXPOSACC, P_MAXNEGACC, P_USUALPOSACC, \
    P_USUALNEGACC, P_MINGAP, P_MAXSPEED, P_HEADWAY, P_YIELD, P_TURNSPEED = range(12)
NUM_PARAMS = 12


@dataclass
class CompiledNet:
    """Static scenario tables (host numpy; moved to device by the engine)."""
    # sizes
    num_lanes: int = 0
    num_links: int = 0
    num_inters: int = 0
    num_roads: int = 0
    num_crosses: int = 0

    # drivables (D = num_lanes + num_links)
    drv_len: np.ndarray = None          # (D,) f64
    drv_max_speed: np.ndarray = None    # (D,) f64  (lanelinks: 10000, roadnet.h:456)
    lane_road: np.ndarray = None        # (L,) i32
    lane_local: np.ndarray = None       # (L,) i32  index within road
    lane_width: np.ndarray = None       # (L,) f64
    road_num_lanes: np.ndarray = None   # (R,) i32
    lane_out: np.ndarray = None         # (L, KO) i32 outgoing lanelink GLOBAL DRIVABLE idx, -1 pad
    ll_start: np.ndarray = None         # (LL,) i32 lane idx
    ll_end: np.ndarray = None           # (LL,) i32 lane idx
    ll_is_turn: np.ndarray = None       # (LL,) bool
    ll_type: np.ndarray = None          # (LL,) i32 (1 right, 2 left, 3 straight)
    ll_inter: np.ndarray = None         # (LL,) i32
    ll_rl_local: np.ndarray = None      # (LL,) i32 roadlink index within intersection

    # lights
    phase_offset: np.ndarray = None     # (I,) i32 into flattened phase rows
    n_phases: np.ndarray = None         # (I,) i32
    phase_time: np.ndarray = None       # (TP,) f64
    phase_rl_avail: np.ndarray = None   # (TP, MAX_RL) bool
    inter_virtual: np.ndarray = None    # (I,) bool

    # crosses
    cross_dist: np.ndarray = None       # (C, 2) f64
    cross_ll: np.ndarray = None         # (C, 2) i32 lanelink idx (not drivable idx)
    ll_cross_idx: np.ndarray = None     # (LL, KC) i32, -1 pad, ASC by distance
    ll_cross_side: np.ndarray = None    # (LL, KC) i32
    # packed per-link cross tables (row-gather-friendly on TPU: one dynamic
    # row index per vehicle instead of (V, KC) element gathers)
    lnk_cross_d: np.ndarray = None      # (LL, KC) f64 distance of cross k on link
    lnk_cross_valid: np.ndarray = None  # (LL, KC) bool
    lnk_cross_selfflat: np.ndarray = None  # (LL, KC) i32 = cross*2 + side
    lnk_cross_foeflat: np.ndarray = None   # (LL, KC) i32 = cross*2 + (1-side)
    lnk_cross_foetype: np.ndarray = None   # (LL, KC) i32 foe lanelink RoadLinkType
    lnk_cross_foe_pos: np.ndarray = None   # (LL, KC) i32 flat (link*KC+slot) of
                                           # the foe side in link-major layout
    cross_end_lane: np.ndarray = None   # (C, 2) i32 end lane of each side's link
    cross_start_lane: np.ndarray = None # (C, 2) i32
    cross_type: np.ndarray = None       # (C, 2) i32 RoadLinkType per side
    cross_is_turn: np.ndarray = None    # (C, 2) bool per side

    # routes
    route_len: np.ndarray = None        # (NR,) i32
    route_roads: np.ndarray = None      # (NR, RLEN) i32, -1 pad
    route_next_ll: np.ndarray = None    # (NR, RLEN, MAXLPR) i32 global DRIVABLE idx of
                                        # selected lanelink, -1 if none/invalid/last
    # flows
    flow_route: np.ndarray = None       # (F,) i32 (-1 invalid)
    flow_params: np.ndarray = None      # (F, 12) f64
    flow_interval: np.ndarray = None    # (F,) f64
    flow_start: np.ndarray = None       # (F,) i32
    flow_end: np.ndarray = None         # (F,) i32

    # host-only metadata
    host: "HostMeta" = None


@dataclass
class HostMeta:
    net: HostRoadNet = None
    flows: List[FlowSpec] = None
    routes: list = None
    config: dict = None
    lane_ids: List[str] = None
    ll_ids: List[str] = None
    inter_ids: List[str] = None
    road_ids: List[str] = None
    inter_index: Dict[str, int] = None
    dir: str = ""
    # paddings actually used
    max_lanes_per_road: int = 0
    ko: int = 0
    kc: int = 0


def compile_scenario(config_path: str) -> CompiledNet:
    with open(config_path) as f:
        config = json.load(f)
    base = config["dir"]
    if not os.path.isabs(base):
        base = os.path.join(os.path.dirname(os.path.abspath(config_path)), base) \
            if not os.path.exists(base) else base
    net = HostRoadNet(os.path.join(base, config["roadnetFile"]))
    flows = flows_mod.load_flows(net, os.path.join(base, config["flowFile"]))
    routes = flows_mod.route_flows(net, flows)
    return compile_arrays(net, flows, routes, config, base)


def compile_arrays(net: HostRoadNet, flows: List[FlowSpec], routes,
                   config: dict, base_dir: str = "") -> CompiledNet:
    L = len(net.lanes)
    LL = len(net.lane_links)
    I = len(net.intersections)
    R = len(net.roads)
    out = CompiledNet(num_lanes=L, num_links=LL, num_inters=I, num_roads=R)

    drv_len = np.zeros(L + LL, np.float64)
    drv_max_speed = np.zeros(L + LL, np.float64)
    for lane in net.lanes:
        drv_len[lane.index] = lane.length
        drv_max_speed[lane.index] = lane.max_speed
    for ll in net.lane_links:
        drv_len[L + ll.index] = ll.length
        drv_max_speed[L + ll.index] = 10000.0  # reference roadnet.h:456
    out.drv_len = drv_len
    out.drv_max_speed = drv_max_speed

    out.lane_road = np.array([l.road.index for l in net.lanes], np.int32)
    out.lane_local = np.array([l.lane_index for l in net.lanes], np.int32)
    out.lane_width = np.array([l.width for l in net.lanes], np.float64)
    out.road_num_lanes = np.array([len(r.lanes) for r in net.roads], np.int32)

    ko = max((len(l.lane_links) for l in net.lanes), default=1) or 1
    lane_out = np.full((L, ko), -1, np.int32)
    for lane in net.lanes:
        for j, ll in enumerate(lane.lane_links):
            lane_out[lane.index, j] = L + ll.index
    out.lane_out = lane_out

    out.ll_start = np.array([ll.start_lane.index for ll in net.lane_links], np.int32) \
        if LL else np.zeros(0, np.int32)
    out.ll_end = np.array([ll.end_lane.index for ll in net.lane_links], np.int32) \
        if LL else np.zeros(0, np.int32)
    out.ll_is_turn = np.array([ll.is_turn() for ll in net.lane_links], bool) \
        if LL else np.zeros(0, bool)
    out.ll_type = np.array([ll.type for ll in net.lane_links], np.int32) \
        if LL else np.zeros(0, np.int32)
    out.ll_inter = np.array([ll.road_link.intersection.index for ll in net.lane_links],
                            np.int32) if LL else np.zeros(0, np.int32)
    out.ll_rl_local = np.array([ll.road_link.index for ll in net.lane_links], np.int32) \
        if LL else np.zeros(0, np.int32)

    # lights
    max_rl = max((len(i.road_links) for i in net.intersections), default=1) or 1
    phase_offset = np.zeros(I, np.int32)
    n_phases = np.zeros(I, np.int32)
    times: List[float] = []
    avail_rows: List[np.ndarray] = []
    for inter in net.intersections:
        phase_offset[inter.index] = len(times)
        n_phases[inter.index] = len(inter.phases)
        for ph in inter.phases:
            times.append(ph.time)
            row = np.zeros(max_rl, bool)
            row[:len(ph.road_link_available)] = ph.road_link_available
            avail_rows.append(row)
    out.phase_offset = phase_offset
    out.n_phases = n_phases
    out.phase_time = np.array(times, np.float64) if times else np.zeros(1, np.float64)
    out.phase_rl_avail = (np.stack(avail_rows) if avail_rows
                          else np.zeros((1, max_rl), bool))
    out.inter_virtual = np.array([i.virtual for i in net.intersections], bool)

    # crosses: global list in intersection order (reference initCrosses order)
    all_crosses = []
    for inter in net.intersections:
        all_crosses.extend(inter.crosses)
    C = len(all_crosses)
    out.num_crosses = C
    cross_index = {id(c): k for k, c in enumerate(all_crosses)}
    out.cross_dist = (np.array([c.distance_on_lane for c in all_crosses], np.float64)
                      if C else np.zeros((0, 2), np.float64))
    out.cross_ll = (np.array([[c.lane_links[0].index, c.lane_links[1].index]
                              for c in all_crosses], np.int32)
                    if C else np.zeros((0, 2), np.int32))
    kc = max((len(ll.crosses) for ll in net.lane_links), default=1) or 1
    ll_cross_idx = np.full((max(LL, 1), kc), -1, np.int32)
    ll_cross_side = np.zeros((max(LL, 1), kc), np.int32)
    for ll in net.lane_links:
        for j, c in enumerate(ll.crosses):   # already sorted ASC by distance
            ll_cross_idx[ll.index, j] = cross_index[id(c)]
            ll_cross_side[ll.index, j] = 0 if c.lane_links[0] is ll else 1
    out.ll_cross_idx = ll_cross_idx
    out.ll_cross_side = ll_cross_side

    # packed per-link / per-side cross tables
    valid = ll_cross_idx >= 0
    safe_idx = np.where(valid, ll_cross_idx, 0)
    out.lnk_cross_valid = valid
    out.lnk_cross_d = np.where(
        valid, out.cross_dist[safe_idx, ll_cross_side], 0.0) \
        if C else np.zeros_like(ll_cross_idx, np.float64)
    out.lnk_cross_selfflat = np.where(valid, safe_idx * 2 + ll_cross_side, 0)
    out.lnk_cross_foeflat = np.where(valid, safe_idx * 2 + (1 - ll_cross_side), 0)
    # link-major position of each cross side and of its foe side
    pos_of = {}
    for l_idx in range(LL):
        for kc in range(kc_pad := ll_cross_idx.shape[1]):
            c = ll_cross_idx[l_idx, kc]
            if c >= 0:
                pos_of[(int(c), int(ll_cross_side[l_idx, kc]))] = \
                    l_idx * kc_pad + kc
    foe_pos = np.zeros_like(ll_cross_idx)
    for l_idx in range(LL):
        for kc in range(ll_cross_idx.shape[1]):
            c = ll_cross_idx[l_idx, kc]
            if c >= 0:
                foe_pos[l_idx, kc] = pos_of[
                    (int(c), 1 - int(ll_cross_side[l_idx, kc]))]
    out.lnk_cross_foe_pos = foe_pos

    if C:
        ll_type_arr = out.ll_type
        out.cross_type = ll_type_arr[out.cross_ll]
        out.cross_is_turn = out.ll_is_turn[out.cross_ll]
        out.cross_end_lane = out.ll_end[out.cross_ll]
        out.cross_start_lane = out.ll_start[out.cross_ll]
        foe_side = 1 - ll_cross_side
        out.lnk_cross_foetype = np.where(
            valid, out.cross_type[safe_idx, foe_side], 0)
    else:
        z2 = np.zeros((0, 2), np.int32)
        out.cross_type = z2
        out.cross_is_turn = np.zeros((0, 2), bool)
        out.cross_end_lane = z2
        out.cross_start_lane = z2
        out.lnk_cross_foetype = np.zeros_like(ll_cross_idx)

    # routes + next-lanelink tables
    # headroom so push_vehicle / set_vehicle_route can register new routes,
    # templates without changing array shapes (no re-jit)
    ROUTE_HEADROOM = 32
    RLEN_HEADROOM = 8
    FLOW_HEADROOM = 32
    NR = max(len(routes), 1) + ROUTE_HEADROOM
    rlen = (max((len(r) for r in routes), default=1) or 1) + RLEN_HEADROOM
    maxlpr = max((len(r.lanes) for r in net.roads), default=1) or 1
    route_len = np.zeros(NR, np.int32)
    route_roads = np.full((NR, rlen), -1, np.int32)
    route_next_ll = np.full((NR, rlen, maxlpr), -1, np.int32)
    for rid, route in enumerate(routes):
        route_len[rid] = len(route)
        for k, road in enumerate(route):
            route_roads[rid, k] = road.index
            for lane in road.lanes:
                nxt = flows_mod.next_lanelink_for(route, k, lane)
                if nxt is not None:
                    route_next_ll[rid, k, lane.lane_index] = L + nxt.index
    out.route_len = route_len
    out.route_roads = route_roads
    out.route_next_ll = route_next_ll

    # flows
    F = max(len(flows), 1) + FLOW_HEADROOM
    out.flow_route = np.full(F, -1, np.int32)
    out.flow_params = np.zeros((F, NUM_PARAMS), np.float64)
    out.flow_interval = np.ones(F, np.float64)
    out.flow_start = np.zeros(F, np.int32)
    out.flow_end = np.full(F, -1, np.int32)
    for fl in flows:
        out.flow_route[fl.index] = fl.route_id
        out.flow_params[fl.index] = fl.template.as_list()
        out.flow_interval[fl.index] = fl.interval
        out.flow_start[fl.index] = fl.start_time
        out.flow_end[fl.index] = fl.end_time

    out.host = HostMeta(
        net=net, flows=flows, routes=routes, config=config,
        lane_ids=[l.id for l in net.lanes],
        ll_ids=[ll.id for ll in net.lane_links],
        inter_ids=[i.id for i in net.intersections],
        road_ids=[r.id for r in net.roads],
        inter_index={i.id: i.index for i in net.intersections},
        dir=base_dir, max_lanes_per_road=maxlpr, ko=ko, kc=kc)
    return out

    # reference parity notes:
    # - drivable registration order (roadnet.cpp:314-323) is lanes in road
    #   order then lanelinks in intersection x roadlink order; our global
    #   indices follow the same order so per-thread sharding tie-breaks in
    #   the reference do not matter (results are threadNum-independent).
