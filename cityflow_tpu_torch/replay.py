"""Replay log writer of the port's Engine, frontend-compatible (the JAX
package's replay.py, on the port's own compiler copies).

The formats are the reference's (roadnetLogFile from
RoadNet::convertToJson, roadnet.cpp:327-394; the per-step text lines of
Engine::updateLog, engine.cpp:518-554), so the bundled PIXI.js player
(frontend/) plays these logs:

  <x> <y> <angle> <id> <lcDir> <len> <width>,...;roadId g/r...,

A vehicle changing lanes is drawn between its lane and the side lane by
its lateral offset, with its last change direction as lcDir.
"""

import json
import math

import numpy as np


def write_roadnet_log(net, path: str):
    """Static geometry document (reference RoadNet::convertToJson)."""
    host = net.host
    nodes = []
    for inter in host.net.intersections:
        node = {"id": inter.id,
                "point": [inter.point[0], inter.point[1]],
                "virtual": inter.virtual}
        if not inter.virtual:
            node["width"] = inter.width
        node["outline"] = [c for p in _outline(inter) for c in p]
        nodes.append(node)
    edges = []
    for r in host.net.roads:
        edges.append({
            "id": r.id,
            "from": r.start_intersection.id,
            "to": r.end_intersection.id,
            "points": [[p[0], p[1]] for p in r.points],
            "nLane": len(r.lanes),
            "laneWidths": [l.width for l in r.lanes]})
    with open(path, "w") as f:
        json.dump({"static": {"nodes": nodes, "edges": edges}}, f)


def _outline(inter):
    """Intersection::getOutline (roadnet.cpp:750-818): convex hull of the
    intersection center plus, per connected road, the two road-edge corner
    points at the trim line and (when the road is long enough) the two
    points deltaWidth further out. Graham scan with the reference's
    lowest-y pivot and angle sort."""
    import math

    def sub(a, b):
        return (a[0] - b[0], a[1] - b[1])

    cx, cy = inter.point
    pts = [(cx, cy)]
    w = inter.width
    for road in inter.roads:
        sx, sy = road.start_intersection.point
        ex, ey = road.end_intersection.point
        dx, dy = ex - sx, ey - sy
        ln = math.hypot(dx, dy) or 1.0
        rdx, rdy = dx / ln, dy / ln
        # Vector::normal() in the reference is (-y, x) (utility.cpp:68-70)
        pdx, pdy = -rdy, rdx
        if road.start_intersection is inter:
            rdx, rdy = -rdx, -rdy
        road_width = sum(l.width for l in road.lanes)
        delta = max(0.5 * min(w, road_width), 5.0)
        ax, ay = cx - rdx * w, cy - rdy * w
        bx, by = ax - pdx * road_width, ay - pdy * road_width
        pts.append((ax, ay))
        pts.append((bx, by))
        avg_len = (sum(l.length for l in road.lanes) / len(road.lanes)
                   if road.lanes else 0.0)
        if delta < avg_len:
            pts.append((ax - rdx * delta, ay - rdy * delta))
            pts.append((bx - rdx * delta, by - rdy * delta))

    if len(pts) < 3:
        return pts
    i0 = min(range(len(pts)), key=lambda i: pts[i][1])
    p0 = pts.pop(i0)
    # libstdc++-exact sort: equal-angle ties (e.g. the duplicate pivot at
    # atan2(0,0)=0) land in std::sort's order, which decides which of the
    # tied points survives the scan
    from cityflow_tpu_torch.compiler.stdsort import std_sort
    std_sort(pts, lambda a, b: (math.atan2(a[1] - p0[1], a[0] - p0[0])
                                < math.atan2(b[1] - p0[1], b[0] - p0[0])))
    stack = [p0]
    for p in pts:
        p2 = stack[-1]
        if len(stack) < 2:
            if p != p2:
                stack.append(p)
            continue
        p1 = stack[-2]
        # crossMultiply(point - p2, p2 - p1) >= 0 -> pop (reference's
        # orientation test keeps a counter-clockwise hull)
        while len(stack) > 1 and (
                (p[0] - p2[0]) * (p2[1] - p1[1])
                - (p[1] - p2[1]) * (p2[0] - p1[0])) >= 0:
            stack.pop()
            p2 = p1
            if len(stack) > 1:
                p1 = stack[-2]
        stack.append(p)
    return stack


class PositionIndex:
    """Per-drivable polyline cumulative lengths for point-at-distance."""

    def __init__(self, net):
        host = net.host
        self.polys = []
        for lane in host.net.lanes:
            self.polys.append(np.asarray(lane.points, np.float64))
        for ll in host.net.lane_links:
            self.polys.append(np.asarray(ll.points, np.float64))
        self.cum = []
        for p in self.polys:
            seg = np.sqrt(((p[1:] - p[:-1]) ** 2).sum(1))
            self.cum.append(np.concatenate([[0.0], np.cumsum(seg)]))

    def point_dir(self, drv: int, dis: float):
        """getPointByDistance + getDirectionByDistance
        (roadnet.cpp:395-410)."""
        p, c = self.polys[drv], self.cum[drv]
        i = int(np.searchsorted(c[1:-1], dis, side="right"))
        seg = p[i + 1] - p[i]
        ln = max(float(np.sqrt((seg ** 2).sum())), 1e-12)
        t = (dis - c[i]) / ln
        pt = p[i] + seg * t
        return pt, seg / ln


def step_line(engine, cache) -> str:
    """One replay text line (Engine::updateLog)."""
    host = engine.net.host
    L = engine.cfg.num_lanes
    if not hasattr(engine, "_pos_index"):
        engine._pos_index = PositionIndex(engine.net)
    pidx = engine._pos_index

    parts = []
    order = engine._pool_order(cache)
    for s in order:
        d = int(cache["drv"][s])
        if d < 0:
            continue
        dis = float(cache["dis"][s])
        off = float(cache.get("offset", np.zeros(1))[s]) \
            if "offset" in cache else 0.0
        pt, u = pidx.point_dir(d, dis)
        if abs(off) > 1e-8 and d < L:
            lane = host.net.lanes[d]
            nb = lane.outer_lane() if off > 0 else lane.inner_lane()
            if nb is not None:
                pt2, _ = pidx.point_dir(nb.index, dis)
                pct = 2 * abs(off) / (lane.width + nb.width)
                pt = pt2 * pct + pt * (1 - pct)
        ang = math.atan2(u[1], u[0])
        lc = int(cache["lc_last_dir"][s]) if "lc_last_dir" in cache else 0
        vid = engine._veh_id(int(cache["uid"][s]))
        ln = float(cache["len"][s])
        wd = float(cache["width"][s])
        # shortest round-trip formatting = the reference's milo dtoa
        # (double2string, utility.h:74-79); python float repr matches it
        parts.append(f"{float(pt[0])!r} {float(pt[1])!r} {float(ang)!r} "
                     f"{vid} {lc} {float(ln)!r} {float(wd)!r},")
    parts.append(";")

    phase = engine._phases_np()
    for road in host.net.roads:
        if road.end_intersection.virtual:
            continue
        seg = [road.id]
        inter = road.end_intersection
        for lane in road.lanes:
            if inter.is_implicit():
                seg.append("i")
                continue
            ph = inter.phases[int(phase[inter.index])]
            can_go = all(ph.road_link_available[ll.road_link.index]
                         for ll in lane.lane_links)
            seg.append("g" if can_go else "r")
        parts.append(" ".join(seg) + ",")
    return "".join(parts)
