#!/usr/bin/env python3
"""Grid scenario generator: rowNum x colNum grid roadnet + flow JSON.

Reimplements the reference generator's scenario format (reference:
tools/generator/generate_grid_scenario.py + generate_json_from_grid.py —
same CLI, same geometry conventions: Hermite-spline lanelink paths, the
8-phase fixed template or the 30s/5s-yellow tlPlan template, straight and
optional turning flows). Used to produce the 1x1..30x30 benchmark configs.
"""

import argparse
import json
import math
import os

# direction k: 0=east(+x), 1=north(+y), 2=west, 3=south
DX = [1, 0, -1, 0]
DY = [0, 1, 0, -1]


def _unit(road):
    (x0, y0), (x1, y1) = road["_p0"], road["_p1"]
    dx, dy = x1 - x0, y1 - y0
    ln = math.sqrt(dx * dx + dy * dy)
    return dx / ln, dy / ln


def _lane_shift(lane_width, lane_index):
    return lane_width * lane_index + lane_width * .5


def _out_point(road, width, lane_index, lane_width):
    dx, dy = _unit(road)
    s = _lane_shift(lane_width, lane_index)
    x, y = road["_p1"]
    x, y = x - dx * width, y - dy * width
    return x + dy * s, y - dx * s


def _in_point(road, width, lane_index, lane_width):
    dx, dy = _unit(road)
    s = _lane_shift(lane_width, lane_index)
    x, y = road["_p0"]
    x, y = x + dx * width, y + dy * width
    return x + dy * s, y - dx * s


def hermite_path(roada, lanea, roadb, laneb, width, lane_width, mid=10):
    """Cubic Hermite between the out-point of (roada, lanea) and the in-point
    of (roadb, laneb), tangents scaled by the intersection width."""
    dxa, dya = _unit(roada)
    dxb, dyb = _unit(roadb)
    pxa, pya = _out_point(roada, width, lanea, lane_width)
    pxb, pyb = _in_point(roadb, width, laneb, lane_width)
    dxa, dya, dxb, dyb = dxa * width, dya * width, dxb * width, dyb * width
    pts = []
    for i in range(mid + 1):
        t = i / mid
        t2, t3 = t * t, t * t * t
        h00 = 2 * t3 - 3 * t2 + 1
        h10 = t3 - 2 * t2 + t
        h01 = -2 * t3 + 3 * t2
        h11 = t3 - t2
        pts.append({"x": h00 * pxa + h10 * dxa + h01 * pxb + h11 * dxb,
                    "y": h00 * pya + h10 * dya + h01 * pyb + h11 * dyb})
    return pts


def link_type(da, db):
    if (da + 1) % 4 == db:
        return "turn_left"
    if (db + 1) % 4 == da:
        return "turn_right"
    if da == db:
        return "go_straight"
    return None


def grid_roadnet(row_num, col_num, row_dist=300, col_dist=300, width=30,
                 lane_width=4.0, lane_max_speed=16.67,
                 n_left=1, n_straight=1, n_right=1, tl_plan=False, mid=10):
    rows, cols = row_num + 2, col_num + 2
    n_lanes = n_left + n_straight + n_right

    def inside(i, j):
        return 0 <= i < rows and 0 <= j < cols

    def inner(i, j):
        return 0 < i < rows - 1 and 0 < j < cols - 1

    def corner(i, j):
        return i in (0, rows - 1) and j in (0, cols - 1)

    # node coordinates: node (i, j) at (j*row_dist - row_dist,
    # i*col_dist - col_dist) — matches the reference accumulation
    X = [[(j - 1) * row_dist for j in range(cols)] for _ in range(rows)]
    Y = [[(i - 1) * col_dist for _ in range(cols)] for i in range(rows)]

    roads = {}
    for i in range(rows):
        for j in range(cols):
            for k in range(4):
                ni, nj = i + DY[k], j + DX[k]
                if not inside(ni, nj):
                    continue
                if not (inner(i, j) or inner(ni, nj)):
                    continue
                roads[(i, j, k)] = {
                    "id": "road_%d_%d_%d" % (j, i, k),
                    "_dir": k,
                    "_from": (i, j), "_to": (ni, nj),
                    "_p0": (X[i][j], Y[i][j]), "_p1": (X[ni][nj], Y[ni][nj]),
                    "points": [{"x": X[i][j], "y": Y[i][j]},
                               {"x": X[ni][nj], "y": Y[ni][nj]}],
                    "lanes": [{"width": lane_width, "maxSpeed": lane_max_speed}
                              for _ in range(n_lanes)],
                    "startIntersection": "intersection_%d_%d" % (j, i),
                    "endIntersection": "intersection_%d_%d" % (nj, ni),
                }

    def lane_role_ok(t, c):
        if t == "turn_left":
            return c < n_left
        if t == "go_straight":
            return n_left <= c < n_left + n_straight
        return n_left + n_straight <= c < n_lanes

    intersections = []
    for i in range(rows):
        for j in range(cols):
            if corner(i, j):
                continue
            w = width if inner(i, j) else 0
            in_roads = [roads[(i - DY[k], j - DX[k], k)]
                        for k in range(4)
                        if (i - DY[k], j - DX[k], k) in roads
                        and roads[(i - DY[k], j - DX[k], k)]["_to"] == (i, j)]
            out_roads = [roads[(i, j, k)] for k in range(4)
                         if (i, j, k) in roads]
            road_links = []
            for ra in in_roads:
                for rb in out_roads:
                    t = link_type(ra["_dir"], rb["_dir"])
                    if t is None:
                        continue
                    lls = []
                    for c in range(n_lanes):
                        if not lane_role_ok(t, c):
                            continue
                        for d in range(n_lanes):
                            lls.append({
                                "startLaneIndex": c, "endLaneIndex": d,
                                "points": hermite_path(ra, c, rb, d, w,
                                                       lane_width, mid)})
                    if lls:
                        road_links.append({
                            "type": t, "startRoad": ra["id"],
                            "endRoad": rb["id"], "direction": ra["_dir"],
                            "laneLinks": lls})
            idxs = range(len(road_links))
            left = {x for x in idxs if road_links[x]["type"] == "turn_left"}
            right = {x for x in idxs if road_links[x]["type"] == "turn_right"}
            straight = {x for x in idxs
                        if road_links[x]["type"] == "go_straight"}
            by_dir = [
                {x for x in idxs if road_links[x]["direction"] == k}
                for k in range(4)]
            WE, NS, EW, SN = by_dir
            phases = []
            if not tl_plan:
                phases.append((5, right))
                phases.append((30, ((EW | WE) & straight) | right))
                phases.append((30, ((NS | SN) & straight) | right))
                phases.append((30, ((EW | WE) & left) | right))
                phases.append((30, ((SN | NS) & left) | right))
                phases.append((30, WE | right))
                phases.append((30, EW | right))
                phases.append((30, NS | right))
                phases.append((30, SN | right))
            else:
                phases.append((30, ((EW | WE) & straight) | right))
                phases.append((5, right))
                if n_left:
                    phases.append((30, ((EW | WE) & left) | right))
                    phases.append((5, right))
                phases.append((30, ((NS | SN) & straight) | right))
                phases.append((5, right))
                if n_left:
                    phases.append((30, ((SN | NS) & left) | right))
                    phases.append((5, right))
            intersections.append({
                "id": "intersection_%d_%d" % (j, i),
                "point": {"x": X[i][j], "y": Y[i][j]},
                "width": w,
                "roads": [r["id"] for r in in_roads + out_roads],
                "roadLinks": [{k: v for k, v in rl.items()}
                              for rl in road_links],
                "trafficLight": {
                    "roadLinkIndices": list(idxs),
                    "lightphases": [
                        {"time": t, "availableRoadLinks": sorted(s)}
                        for t, s in phases]},
                "virtual": not inner(i, j),
            })

    final_roads = []
    for key in sorted(roads, key=lambda k: (k[0], k[1], k[2])):
        r = dict(roads[key])
        for drop in ("_dir", "_from", "_to", "_p0", "_p1"):
            r.pop(drop)
        final_roads.append(r)
    return {"intersections": intersections, "roads": final_roads}


def straight_routes(row_num, col_num):
    routes = []
    move = [(1, 0), (0, 1), (-1, 0), (0, -1)]

    def run(start, d, steps):
        x, y = start
        out = []
        for _ in range(steps):
            out.append("road_%d_%d_%d" % (x, y, d))
            x += move[d][0]
            y += move[d][1]
        return out

    for i in range(1, row_num + 1):
        routes.append(run((0, i), 0, col_num + 1))
        routes.append(run((col_num + 1, i), 2, col_num + 1))
    for i in range(1, col_num + 1):
        routes.append(run((i, 0), 1, row_num + 1))
        routes.append(run((i, row_num + 1), 3, row_num + 1))
    return routes


def turn_routes(row_num, col_num):
    move = [(1, 0), (0, 1), (-1, 0), (0, -1)]

    def run(start, dirs):
        steps = (min(row_num * 2, col_num * 2 + 1) if dirs[0] % 2 == 0
                 else min(col_num * 2, row_num * 2 + 1))
        x, y = start
        out = []
        cur = 0
        for _ in range(steps):
            out.append("road_%d_%d_%d" % (x, y, dirs[cur]))
            x += move[dirs[cur]][0]
            y += move[dirs[cur]][1]
            cur = 1 - cur
        return out

    return [run((1, 0), (1, 0)), run((0, 1), (0, 1)),
            run((col_num + 1, row_num), (2, 3)),
            run((col_num, row_num + 1), (3, 2)),
            run((0, row_num), (0, 3)), run((1, row_num + 1), (3, 0)),
            run((col_num + 1, 1), (2, 1)), run((col_num, 0), (1, 2))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("rowNum", type=int)
    ap.add_argument("colNum", type=int)
    ap.add_argument("--rowDistance", type=int, default=300)
    ap.add_argument("--columnDistance", type=int, default=300)
    ap.add_argument("--intersectionWidth", type=int, default=30)
    ap.add_argument("--numLeftLanes", type=int, default=1)
    ap.add_argument("--numStraightLanes", type=int, default=1)
    ap.add_argument("--numRightLanes", type=int, default=1)
    ap.add_argument("--laneMaxSpeed", type=float, default=16.67)
    ap.add_argument("--vehLen", type=float, default=5.0)
    ap.add_argument("--vehWidth", type=float, default=2.0)
    ap.add_argument("--vehMaxPosAcc", type=float, default=2.0)
    ap.add_argument("--vehMaxNegAcc", type=float, default=4.5)
    ap.add_argument("--vehUsualPosAcc", type=float, default=2.0)
    ap.add_argument("--vehUsualNegAcc", type=float, default=4.5)
    ap.add_argument("--vehMinGap", type=float, default=2.5)
    ap.add_argument("--vehMaxSpeed", type=float, default=16.67)
    ap.add_argument("--vehHeadwayTime", type=float, default=1.5)
    ap.add_argument("--dir", type=str, default="./")
    ap.add_argument("--roadnetFile", type=str)
    ap.add_argument("--turn", action="store_true")
    ap.add_argument("--tlPlan", action="store_true")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--flowFile", type=str)
    args = ap.parse_args(argv)

    rn = args.roadnetFile or "roadnet_%d_%d%s.json" % (
        args.rowNum, args.colNum, "_turn" if args.turn else "")
    fl = args.flowFile or "flow_%d_%d%s.json" % (
        args.rowNum, args.colNum, "_turn" if args.turn else "")
    doc = grid_roadnet(args.rowNum, args.colNum, args.rowDistance,
                       args.columnDistance, args.intersectionWidth,
                       4.0, args.laneMaxSpeed, args.numLeftLanes,
                       args.numStraightLanes, args.numRightLanes,
                       args.tlPlan)
    json.dump(doc, open(os.path.join(args.dir, rn), "w"), indent=2)

    tpl = {"length": args.vehLen, "width": args.vehWidth,
           "maxPosAcc": args.vehMaxPosAcc, "maxNegAcc": args.vehMaxNegAcc,
           "usualPosAcc": args.vehUsualPosAcc,
           "usualNegAcc": args.vehUsualNegAcc, "minGap": args.vehMinGap,
           "maxSpeed": args.vehMaxSpeed, "headwayTime": args.vehHeadwayTime}
    routes = straight_routes(args.rowNum, args.colNum)
    if args.turn:
        routes += turn_routes(args.rowNum, args.colNum)
    flow = [{"vehicle": tpl, "route": r, "interval": args.interval,
             "startTime": 0, "endTime": -1} for r in routes]
    json.dump(flow, open(os.path.join(args.dir, fl), "w"), indent=2)
    print("wrote", rn, "and", fl)


if __name__ == "__main__":
    main()
