"""Host-side flow parsing and routing (compile step).

Parses CityFlow flow JSON into flow records and runs the reference's routing
algorithm (Dijkstra over roads, edge cost = destination road's average lane
length) to produce per-flow road routes and per-(route, position, lane)
next-lanelink selection tables.

Reference semantics reproduced:
- Engine::loadFlow (engine.cpp:106-164): vehicle template fields, interval,
  startTime/endTime, id "flow_<i>".
- Router::updateShortestPath / dijkstra (router.cpp:160-243): per consecutive
  anchor pair; priority_queue pop order replicated via StdPriorityQueue;
  adjacency = end intersection's road list filtered by connectedToRoad;
  strict-< relaxation; path reconstruction excludes the start anchor.
- Router::getNextDrivable / selectLaneLink / selectLaneIndex
  (router.cpp:49-129): next lanelink = min |endLaneIndex - curLaneIndex|
  (first win) over lanelinks to the next road, filtered two roads ahead.
- Router::getFirstDrivable (router.cpp:23-37): candidate first lanes.
"""

import json
from dataclasses import dataclass, field
from typing import List, Optional

from cityflow_tpu_torch.compiler.roadnet import HostRoadNet, Road, Lane, LaneLink
from cityflow_tpu_torch.compiler.stdheap import StdPriorityQueue


@dataclass
class VehicleTemplate:
    # order matches PARAM_* indices in compiler/net.py
    speed: float = 0.0
    len: float = 5.0
    width: float = 2.0
    maxPosAcc: float = 4.5
    maxNegAcc: float = 4.5
    usualPosAcc: float = 2.5
    usualNegAcc: float = 2.5
    minGap: float = 2.0
    maxSpeed: float = 16.66667
    headwayTime: float = 1.0
    yieldDistance: float = 5.0
    turnSpeed: float = 8.3333

    def as_list(self) -> List[float]:
        return [self.speed, self.len, self.width, self.maxPosAcc,
                self.maxNegAcc, self.usualPosAcc, self.usualNegAcc,
                self.minGap, self.maxSpeed, self.headwayTime,
                self.yieldDistance, self.turnSpeed]


@dataclass
class FlowSpec:
    index: int
    id: str
    template: VehicleTemplate
    anchors: List[Road]                 # route anchor roads from flow JSON
    interval: float
    start_time: int = 0
    end_time: int = -1
    # filled by routing:
    route: Optional[List[Road]] = None  # expanded road sequence (None=invalid)
    route_id: int = -1
    first_lane_candidates: List[Lane] = field(default_factory=list)


def road_average_length(road: Road) -> float:
    # reference Road::averageLength (roadnet.h): sum lane lengths / count,
    # float accumulation in lane order
    total = 0.0
    for lane in road.lanes:
        total += lane.length
    return 0.0 if not road.lanes else total / len(road.lanes)


def connected_to_road(a: Road, b: Road) -> bool:
    for lane in a.lanes:
        if lane.lane_links_to_road(b):
            return True
    return False


def length_cost(road: Road) -> float:
    """RouterType::LENGTH edge cost (router.cpp:191-193)."""
    return road_average_length(road)


def duration_cost_fn(road_duration, max_speed: float):
    """RouterType::DURATION edge cost (router.cpp:193-200): the road's
    historical average duration (Road::getAverageDuration,
    roadnet.cpp:730-734), falling back to length/vehicle.maxSpeed when the
    240-step history holds no vehicles. `road_duration` maps road index ->
    duration or a negative sentinel (built by Engine from the device-side
    lane history)."""
    def cost(road: Road) -> float:
        avg = road_duration.get(road.index, -1.0)
        if avg < 0:
            # Road::getLength = SUM of lane lengths (roadnet.cpp:701-707)
            total = 0.0
            for lane in road.lanes:
                total += lane.length
            avg = total / max_speed
        return avg
    return cost


def dijkstra(net: HostRoadNet, start: Road, end: Road, buffer: List[Road],
             cost=length_cost) -> bool:
    """reference: router.cpp:160-226 — appends path (excl. start) to buffer."""
    dis = {}
    frm = {}
    visited = set()
    success = False
    queue = StdPriorityQueue(lambda a, b: a[1] > b[1])
    dis[start.index] = 0.0
    queue.push((start, 0.0))
    while not queue.empty():
        cur_road = queue.top()[0]
        if cur_road is end:
            success = True
            break
        queue.pop()
        if cur_road.index in visited:
            continue
        visited.add(cur_road.index)
        cur_dis = dis[cur_road.index]
        for adj_road in cur_road.end_intersection.roads:
            if not connected_to_road(cur_road, adj_road):
                continue
            new_dis = cur_dis + cost(adj_road)
            old = dis.get(adj_road.index)
            if old is None or new_dis < old:
                frm[adj_road.index] = cur_road
                dis[adj_road.index] = new_dis
                queue.push((adj_road, new_dis))

    path = [end]
    it = frm.get(end.index)
    while it is not None and it is not start:
        path.append(it)
        it = frm.get(it.index)
    buffer.extend(reversed(path))
    return success


def update_shortest_path(net: HostRoadNet, anchors: List[Road],
                         cost=length_cost) -> Optional[List[Road]]:
    """reference: router.cpp:228-243. Returns road route or None if invalid."""
    route = [anchors[0]]
    for i in range(1, len(anchors)):
        if anchors[i - 1] is anchors[i]:
            continue
        if not dijkstra(net, anchors[i - 1], anchors[i], route, cost=cost):
            return None
    if len(route) <= 1:
        return None
    return route


def select_lane_index(cur_lane: Optional[Lane], lanes: List[Lane]) -> int:
    """reference: router.cpp:96-112 (cur_lane != None branch only)."""
    assert cur_lane is not None and lanes
    lane_diff = None
    selected = -1
    for i, lane in enumerate(lanes):
        cur = abs(lane.lane_index - cur_lane.lane_index)
        if lane_diff is None or cur < lane_diff:
            lane_diff = cur
            selected = i
    return selected


def select_lane_link(cur_lane: Lane, lane_links: List[LaneLink]) -> Optional[LaneLink]:
    if not lane_links:
        return None
    lanes = [ll.end_lane for ll in lane_links]
    return lane_links[select_lane_index(cur_lane, lanes)]


def next_lanelink_for(route: List[Road], k: int, lane: Lane) -> Optional[LaneLink]:
    """The lanelink Router::getNextDrivable picks from `lane` on route[k]
    (router.cpp:49-76). None if last road or no valid link (invalid lane)."""
    n = len(route)
    if k >= n - 1:
        return None
    links = lane.lane_links_to_road(route[k + 1])
    if k == n - 2:
        return select_lane_link(lane, links)
    candidates = [ll for ll in links
                  if ll.end_lane.lane_links_to_road(route[k + 2])]
    return select_lane_link(lane, candidates)


def first_lane_candidates(route: List[Road]) -> List[Lane]:
    """reference: router.cpp:23-37."""
    lanes = route[0].lanes
    if len(route) == 1:
        return list(lanes)
    return [l for l in lanes if l.lane_links_to_road(route[1])]


def load_flows(net: HostRoadNet, path: str) -> List[FlowSpec]:
    with open(path) as f:
        doc = json.load(f)
    flows: List[FlowSpec] = []
    for i, fv in enumerate(doc):
        veh = fv["vehicle"]
        tpl = VehicleTemplate(
            len=float(veh["length"]), width=float(veh["width"]),
            maxPosAcc=float(veh["maxPosAcc"]), maxNegAcc=float(veh["maxNegAcc"]),
            usualPosAcc=float(veh["usualPosAcc"]), usualNegAcc=float(veh["usualNegAcc"]),
            minGap=float(veh["minGap"]), maxSpeed=float(veh["maxSpeed"]),
            headwayTime=float(veh["headwayTime"]))
        anchors = [net.road_map[r] for r in fv["route"]]
        flow = FlowSpec(index=i, id=f"flow_{i}", template=tpl, anchors=anchors,
                        interval=float(fv["interval"]),
                        start_time=int(fv.get("startTime", 0)),
                        end_time=int(fv.get("endTime", -1)))
        flows.append(flow)
    return flows


def route_flows(net: HostRoadNet, flows: List[FlowSpec]):
    """Run routing for every flow; dedup identical road sequences into route
    ids. Returns (routes: List[List[Road]], per-flow assignments in place)."""
    routes: List[List[Road]] = []
    key_to_id = {}
    for flow in flows:
        route = update_shortest_path(net, flow.anchors)
        flow.route = route
        if route is None:
            flow.route_id = -1
            continue
        key = tuple(r.index for r in route)
        rid = key_to_id.get(key)
        if rid is None:
            rid = len(routes)
            key_to_id[key] = rid
            routes.append(route)
        flow.route_id = rid
        flow.first_lane_candidates = first_lane_candidates(route)
    return routes
