"""Host-side roadnet model: parses CityFlow roadnet JSON and reconstructs the
static topology (lanes, lanelinks, conflict crosses, signal phases) with
bit-exact double-precision geometry.

Construction order mirrors the reference loader so derived floats match
exactly (reference: roadnet.cpp:42-325 loadFromJson, roadnet.cpp:456-505
initLanesPoints, roadnet.cpp:515-576 initCrosses):

1. roads (lanes, centerline points)
2. first lane-points pass WITHOUT intersection-width trimming (widths are not
   yet known at that point in the reference loader; default lanelink curves
   sample these untrimmed points)
3. intersections (roadlinks, lanelinks w/ explicit points or default curves,
   light phases)
4. conflict-cross discovery per intersection (pairwise lanelink segment
   intersection tests, first hit wins)
5. second lane-points pass WITH intersection-width trimming (final lengths)
6. per-road segmentation
"""

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from cityflow_tpu_torch.compiler import geometry as geo
from cityflow_tpu_torch.compiler.stdsort import std_sort

# RoadLinkType values (reference: roadnet.h:401-403)
TURN_LEFT = 2
TURN_RIGHT = 1
GO_STRAIGHT = 3
_TYPE_MAP = {"turn_left": TURN_LEFT, "turn_right": TURN_RIGHT, "go_straight": GO_STRAIGHT}

# segmentation density: (default vehicle len 5 + minGap 2) * MAX_NUM_CARS_ON_SEGMENT 10
# (reference: utility/config.h:5, roadnet.cpp:310-312)
SEGMENT_INTERVAL = (5.0 + 2.0) * 10


@dataclass
class Lane:
    index: int              # global lane index
    lane_index: int         # index within road
    road: "Road" = None
    width: float = 0.0
    max_speed: float = 0.0
    points: List[geo.Point] = field(default_factory=list)
    length: float = 0.0
    lane_links: List["LaneLink"] = field(default_factory=list)  # outgoing
    num_segments: int = 1

    @property
    def id(self) -> str:
        return f"{self.road.id}_{self.lane_index}"

    def inner_lane(self) -> Optional["Lane"]:
        return self.road.lanes[self.lane_index - 1] if self.lane_index > 0 else None

    def outer_lane(self) -> Optional["Lane"]:
        return (self.road.lanes[self.lane_index + 1]
                if self.lane_index < len(self.road.lanes) - 1 else None)

    def lane_links_to_road(self, road: "Road") -> List["LaneLink"]:
        return [ll for ll in self.lane_links if ll.end_lane.road is road]


@dataclass
class Road:
    index: int
    id: str
    start_intersection: "Intersection" = None
    end_intersection: "Intersection" = None
    lanes: List[Lane] = field(default_factory=list)
    points: List[geo.Point] = field(default_factory=list)

    def average_length(self) -> float:
        if not self.lanes:
            return 0.0
        total = 0.0
        for lane in self.lanes:
            total += lane.length
        return total / len(self.lanes)

    def connected_to_road(self, road: "Road") -> bool:
        return any(lane.lane_links_to_road(road) for lane in self.lanes)

    def init_lanes_points(self) -> None:
        # reference: roadnet.cpp:456-505 (called twice; see module docstring)
        pts = list(self.points)
        assert len(pts) >= 2
        if self.start_intersection is not None and not self.start_intersection.virtual:
            w = self.start_intersection.width
            p1, p2 = pts[0], pts[1]
            pts[0] = geo.add(p1, geo.mul(geo.unit(geo.sub(p2, p1)), w))
        if self.end_intersection is not None and not self.end_intersection.virtual:
            w = self.end_intersection.width
            p1, p2 = pts[-2], pts[-1]
            pts[-1] = geo.sub(p2, geo.mul(geo.unit(geo.sub(p2, p1)), w))

        dsum = 0.0
        for lane in self.lanes:
            dmin, dmax = dsum, dsum + lane.width
            off = (dmin + dmax) / 2.0
            lane_points = []
            n = len(pts)
            for j in range(n):
                if j == 0:
                    u = geo.unit(geo.sub(pts[1], pts[0]))
                elif j + 1 == n:
                    u = geo.unit(geo.sub(pts[j], pts[j - 1]))
                else:
                    u1 = geo.unit(geo.sub(pts[j + 1], pts[j]))
                    u2 = geo.unit(geo.sub(pts[j], pts[j - 1]))
                    u = geo.unit(geo.add(u1, u2))
                v = geo.mul(geo.normal(u), -1.0)  # -u.normal()
                lane_points.append(geo.add(pts[j], geo.mul(v, off)))
            lane.points = lane_points
            lane.length = geo.polyline_length(lane_points)
            dsum += lane.width


@dataclass
class LaneLink:
    index: int              # global lanelink index
    road_link: "RoadLink" = None
    start_lane: Lane = None
    end_lane: Lane = None
    points: List[geo.Point] = field(default_factory=list)
    length: float = 0.0
    width: float = 4.0      # reference: LaneLink ctor, roadnet.h:454-458
    crosses: List["Cross"] = field(default_factory=list)  # sorted by distance

    @property
    def id(self) -> str:
        return f"{self.start_lane.id}_TO_{self.end_lane.id}"

    @property
    def type(self) -> int:
        return self.road_link.type

    def is_turn(self) -> bool:
        return self.type in (TURN_LEFT, TURN_RIGHT)

    def distance_on_lane(self, cross: "Cross") -> float:
        return cross.distance_on_lane[0 if cross.lane_links[0] is self else 1]


@dataclass
class RoadLink:
    index: int              # index within intersection
    intersection: "Intersection" = None
    start_road: Road = None
    end_road: Road = None
    type: int = GO_STRAIGHT
    lane_links: List[LaneLink] = field(default_factory=list)


@dataclass
class Cross:
    lane_links: List[LaneLink] = None        # [la, lb]
    distance_on_lane: List[float] = None     # [da, db]
    ang: float = 0.0
    safe_distances: List[float] = None


@dataclass
class LightPhase:
    time: float
    road_link_available: List[bool]


@dataclass
class Intersection:
    index: int
    id: str
    point: geo.Point = (0.0, 0.0)
    virtual: bool = False
    width: float = 0.0
    roads: List[Road] = field(default_factory=list)
    road_links: List[RoadLink] = field(default_factory=list)
    crosses: List[Cross] = field(default_factory=list)
    phases: List[LightPhase] = field(default_factory=list)

    def lane_links(self) -> List[LaneLink]:
        out = []
        for rl in self.road_links:
            out.extend(rl.lane_links)
        return out

    def is_implicit(self) -> bool:
        return len(self.phases) <= 1

    def init_crosses(self) -> None:
        # reference: roadnet.cpp:515-576
        all_lls = self.lane_links()
        n = len(all_lls)
        if n > 1 and self._init_crosses_native(all_lls):
            return
        for i in range(n):
            for j in range(i + 1, n):
                la, lb = all_lls[i], all_lls[j]
                va, vb = la.points, lb.points
                found = False
                disa = 0.0
                for ia in range(len(va) - 1):
                    disb = 0.0
                    for ib in range(len(vb) - 1):
                        a1, a2 = va[ia], va[ia + 1]
                        b1, b2 = vb[ib], vb[ib + 1]
                        if geo.sign(geo.cross(geo.sub(a2, a1), geo.sub(b2, b1))) == 0:
                            continue
                        p = geo.calc_intersect_point(a1, a2, b1, b2)
                        if geo.on_segment(a1, a2, p) and geo.on_segment(b1, b2, p):
                            ang = geo.calc_ang(geo.sub(a2, a1), geo.sub(b2, b1))
                            w1, w2 = la.width, lb.width
                            # C++ divides by sin(ang) without guarding ang==0
                            # (perpendicular links fold to 0): IEEE gives inf,
                            # and sqrt(inf - c) = inf; replicate with a raw
                            # float division instead of raising.
                            sin_a = math.sin(ang)
                            c1 = w1 / sin_a if sin_a != 0.0 else math.inf
                            c2 = w2 / sin_a if sin_a != 0.0 else math.inf
                            diag = (c1 * c1 + c2 * c2 + 2 * c1 * c2 * math.cos(ang)) / 4
                            cross = Cross(
                                lane_links=[la, lb],
                                distance_on_lane=[disa + geo.length(geo.sub(p, a1)),
                                                  disb + geo.length(geo.sub(p, b1))],
                                ang=ang,
                                safe_distances=[math.sqrt(diag - w2 * w2 / 4),
                                                math.sqrt(diag - w1 * w1 / 4)],
                            )
                            self.crosses.append(cross)
                            found = True
                            break
                        disb += geo.length(geo.sub(vb[ib + 1], vb[ib]))
                    if found:
                        break
                    disa += geo.length(geo.sub(va[ia + 1], va[ia]))
        for cross in self.crosses:
            cross.lane_links[0].crosses.append(cross)
            cross.lane_links[1].crosses.append(cross)
        for ll in all_lls:
            # std::sort (unstable introsort) — tie order at equal distances is
            # load-bearing for the cross-yield scan; replicate libstdc++.
            std_sort(ll.crosses,
                     lambda ca, cb: (ca.distance_on_lane[0 if ca.lane_links[0] is ll else 1]
                                     < cb.distance_on_lane[0 if cb.lane_links[0] is ll else 1]))

    def _init_crosses_native(self, all_lls) -> bool:
        """C++ kernel path (cityflow_tpu_torch/native): bit-identical doubles,
        real libstdc++ std::sort for the per-link tie order."""
        from cityflow_tpu_torch import native
        import ctypes
        import numpy as np
        lib = native.get_lib()
        if lib is None:
            return False
        n = len(all_lls)
        offsets = np.zeros(n + 1, np.int64)
        for i, ll in enumerate(all_lls):
            offsets[i + 1] = offsets[i] + len(ll.points)
        pts = np.empty((offsets[-1], 2), np.float64)
        for i, ll in enumerate(all_lls):
            pts[offsets[i]:offsets[i + 1]] = ll.points
        widths = np.array([ll.width for ll in all_lls], np.float64)
        cap = max(n * n, 16)
        oa = np.zeros(cap, np.int64)
        ob = np.zeros(cap, np.int64)
        oda = np.zeros(cap, np.float64)
        odb = np.zeros(cap, np.float64)
        oang = np.zeros(cap, np.float64)
        osa = np.zeros(cap, np.float64)
        osb = np.zeros(cap, np.float64)
        D = ctypes.POINTER(ctypes.c_double)
        L = ctypes.POINTER(ctypes.c_longlong)
        cnt = lib.find_crosses(
            n, pts.ctypes.data_as(D), offsets.ctypes.data_as(L),
            widths.ctypes.data_as(D), cap,
            oa.ctypes.data_as(L), ob.ctypes.data_as(L),
            oda.ctypes.data_as(D), odb.ctypes.data_as(D),
            oang.ctypes.data_as(D), osa.ctypes.data_as(D),
            osb.ctypes.data_as(D))
        if cnt < 0:
            return False
        for k in range(cnt):
            cross = Cross(
                lane_links=[all_lls[oa[k]], all_lls[ob[k]]],
                distance_on_lane=[float(oda[k]), float(odb[k])],
                ang=float(oang[k]),
                safe_distances=[float(osa[k]), float(osb[k])])
            self.crosses.append(cross)
            cross.lane_links[0].crosses.append(cross)
            cross.lane_links[1].crosses.append(cross)
        # per-link sort with the real std::sort
        for ll in all_lls:
            m = len(ll.crosses)
            if m < 2:
                continue
            order = np.arange(m, dtype=np.int64)
            dist = np.array([c.distance_on_lane[0 if c.lane_links[0] is ll
                                                else 1] for c in ll.crosses],
                            np.float64)
            lib.sort_link_crosses(m, order.ctypes.data_as(L),
                                  dist.ctypes.data_as(D))
            ll.crosses = [ll.crosses[int(j)] for j in order]
        return True


def _default_lanelink_points(start_lane: Lane, end_lane: Lane) -> List[geo.Point]:
    # reference: roadnet.cpp:212-247 — generated only when the roadnet JSON
    # omits lanelink points; uses the UNtrimmed first-pass lane points.
    start = geo.point_by_distance(
        start_lane.points, start_lane.length - start_lane.road.end_intersection.width)
    end = geo.point_by_distance(end_lane.points, 0.0 + end_lane.road.start_intersection.width)
    ln = geo.length(geo.sub(end, start))
    start_dir = geo.direction_by_distance(
        start_lane.points, start_lane.length - start_lane.road.end_intersection.width)
    end_dir = geo.direction_by_distance(end_lane.points, 0.0 + end_lane.road.start_intersection.width)
    min_gap = 5.0
    g1x, g1y = start_dir[0] * ln * 0.5, start_dir[1] * ln * 0.5
    g2x, g2y = -end_dir[0] * ln * 0.5, -end_dir[1] * ln * 0.5
    if g1x * g1x + g1y * g1y < 25 and start_lane.road.end_intersection.width >= 5:
        g1x, g1y = min_gap * start_dir[0], min_gap * start_dir[1]
    if g2x * g2x + g2y * g2y < 25 and end_lane.road.start_intersection.width >= 5:
        g2x, g2y = min_gap * end_dir[0], min_gap * end_dir[1]
    mid1 = (start[0] + g1x, start[1] + g1y)
    mid2 = (end[0] + g2x, end[1] + g2y)

    def lerp(p1, p2, a):
        return ((p2[0] - p1[0]) * a + p1[0], (p2[1] - p1[1]) * a + p1[1])

    num = 10
    pts = []
    for i in range(num + 1):
        a = i / float(num)
        p1 = lerp(start, mid1, a)
        p2 = lerp(mid1, mid2, a)
        p3 = lerp(mid2, end, a)
        p4 = lerp(p1, p2, a)
        p5 = lerp(p2, p3, a)
        p6 = lerp(p4, p5, a)
        pts.append(p6)
    return pts


class HostRoadNet:
    """The parsed static roadnet (host object graph, compile-time only)."""

    def __init__(self, path: str):
        with open(path) as f:
            doc = json.load(f, parse_float=float, parse_int=int)
        self.roads: List[Road] = []
        self.intersections: List[Intersection] = []
        self.lanes: List[Lane] = []
        self.lane_links: List[LaneLink] = []
        self.road_map: Dict[str, Road] = {}
        self.inter_map: Dict[str, Intersection] = {}
        self._load(doc)

    def _load(self, doc) -> None:
        inter_values = doc["intersections"]
        road_values = doc["roads"]

        for i, rv in enumerate(road_values):
            road = Road(index=i, id=rv["id"])
            self.roads.append(road)
            self.road_map[road.id] = road
        for i, iv in enumerate(inter_values):
            inter = Intersection(index=i, id=iv["id"])
            self.intersections.append(inter)
            self.inter_map[inter.id] = inter

        lane_counter = 0
        for i, rv in enumerate(road_values):
            road = self.roads[i]
            road.start_intersection = self.inter_map[rv["startIntersection"]]
            road.end_intersection = self.inter_map[rv["endIntersection"]]
            for k, lv in enumerate(rv["lanes"]):
                lane = Lane(index=lane_counter, lane_index=k, road=road,
                            width=float(lv["width"]), max_speed=float(lv["maxSpeed"]))
                road.lanes.append(lane)
                self.lanes.append(lane)
                lane_counter += 1
            road.points = [(float(p["x"]), float(p["y"])) for p in rv["points"]]

        # first pass: untrimmed lane points (intersection widths unknown in the
        # reference at this stage of loading)
        for road in self.roads:
            saved = [(road.start_intersection, road.end_intersection)]
            # emulate "widths not yet read": treat both ends as zero-width
            si, ei = road.start_intersection, road.end_intersection
            sw, ew, sv, ev = si.width, ei.width, si.virtual, ei.virtual
            si.width = 0.0
            ei.width = 0.0
            road.init_lanes_points()
            si.width, ei.width = sw, ew
            del saved

        # intersections
        ll_counter = 0
        for i, iv in enumerate(inter_values):
            inter = self.intersections[i]
            inter.virtual = bool(iv["virtual"])
            inter.point = (float(iv["point"]["x"]), float(iv["point"]["y"]))
            inter.roads = [self.road_map[r] for r in iv["roads"]]
            if inter.virtual:
                continue
            inter.width = float(iv["width"])
            for rli, rlv in enumerate(iv["roadLinks"]):
                rl = RoadLink(index=rli, intersection=inter,
                              start_road=self.road_map[rlv["startRoad"]],
                              end_road=self.road_map[rlv["endRoad"]],
                              type=_TYPE_MAP[rlv["type"]])
                inter.road_links.append(rl)
                for llv in rlv["laneLinks"]:
                    start_lane = rl.start_road.lanes[llv["startLaneIndex"]]
                    end_lane = rl.end_road.lanes[llv["endLaneIndex"]]
                    pts = llv.get("points") or None
                    if pts:
                        points = [(float(p["x"]), float(p["y"])) for p in pts]
                    else:
                        points = _default_lanelink_points(start_lane, end_lane)
                    ll = LaneLink(index=ll_counter, road_link=rl,
                                  start_lane=start_lane, end_lane=end_lane,
                                  points=points, length=geo.polyline_length(points))
                    ll_counter += 1
                    rl.lane_links.append(ll)
                    start_lane.lane_links.append(ll)
            for pv in iv["trafficLight"]["lightphases"]:
                avail = [False] * len(inter.road_links)
                for idx in pv["availableRoadLinks"]:
                    avail[idx] = True
                inter.phases.append(LightPhase(time=float(pv["time"]), road_link_available=avail))

        # conflict crosses (before the final lane-points pass, as in reference)
        for inter in self.intersections:
            inter.init_crosses()

        # second pass: final lane points with intersection-width trimming
        for road in self.roads:
            road.init_lanes_points()

        # segmentation (per-road numSegs from the road centerline length)
        for road in self.roads:
            num_segs = max(int(math.ceil(geo.polyline_length(road.points) / SEGMENT_INTERVAL)), 1)
            for lane in road.lanes:
                lane.num_segments = num_segs

        # global lanelink order: intersections x roadlinks x lanelinks
        # (matches reference drivable registration, roadnet.cpp:314-323)
        for inter in self.intersections:
            self.lane_links.extend(inter.lane_links())

        # lanelink indices were assigned in parse order == registration order
        for idx, ll in enumerate(self.lane_links):
            assert ll.index == idx

    # drivable indexing convention: [0, L) lanes, [L, L+LL) lanelinks
    @property
    def num_lanes(self) -> int:
        return len(self.lanes)

    @property
    def num_drivables(self) -> int:
        return len(self.lanes) + len(self.lane_links)

    def drivable_id(self, idx: int) -> str:
        if idx < len(self.lanes):
            return self.lanes[idx].id
        return self.lane_links[idx - len(self.lanes)].id
