"""Exact double-precision polyline/intersection geometry (host side).

Pure-Python floats are IEEE doubles, so replicating the reference's operation
order reproduces its results bit-for-bit. Semantics mirror
the reference src/utility/utility.{h,cpp} (Point ops, sign with eps,
segment intersection) and src/roadnet/roadnet.cpp (polyline
length / point-at-distance / lane offsetting / cross discovery) without
copying code — these are standard computational-geometry formulas.
"""

import math
from typing import List, Tuple

EPS = 1e-8

Point = Tuple[float, float]


def sign(x: float) -> int:
    # reference Point::sign: (x + eps > 0) - (x < eps)
    return (1 if x + EPS > 0 else 0) - (1 if x < EPS else 0)


def sub(a: Point, b: Point) -> Point:
    return (a[0] - b[0], a[1] - b[1])


def add(a: Point, b: Point) -> Point:
    return (a[0] + b[0], a[1] + b[1])


def mul(a: Point, k: float) -> Point:
    return (a[0] * k, a[1] * k)


def length(a: Point) -> float:
    return math.sqrt(a[0] * a[0] + a[1] * a[1])


def unit(a: Point) -> Point:
    l = length(a)
    return (a[0] / l, a[1] / l)


def normal(a: Point) -> Point:
    # rotate +90deg: (-y, x)
    return (-a[1], a[0])


def cross(a: Point, b: Point) -> float:
    return a[0] * b[1] - a[1] * b[0]


def dot(a: Point, b: Point) -> float:
    return a[0] * b[0] + a[1] * b[1]


def ang_of(a: Point) -> float:
    return math.atan2(a[1], a[0])


def calc_ang(a: Point, b: Point) -> float:
    # acute angle between two directions, folded into [0, pi/2)
    ang = ang_of(a) - ang_of(b)
    pi = math.acos(-1.0)
    while ang >= pi / 2:
        ang -= pi / 2
    while ang < 0:
        ang += pi / 2
    return min(ang, pi - ang)


def calc_intersect_point(a: Point, b: Point, c: Point, d: Point) -> Point:
    u = sub(b, a)
    v = sub(d, c)
    return add(a, mul(u, cross(sub(c, a), v) / cross(u, v)))


def on_segment(a: Point, b: Point, p: Point) -> bool:
    v1 = cross(sub(b, a), sub(p, a))
    v2 = dot(sub(p, a), sub(p, b))
    return sign(v1) == 0 and sign(v2) <= 0


def polyline_length(points: List[Point]) -> float:
    total = 0.0
    for i in range(len(points) - 1):
        total += length(sub(points[i + 1], points[i]))
    return total


def point_by_distance(points: List[Point], dis: float) -> Point:
    dis = min(max(dis, 0.0), polyline_length(points))
    if dis <= 0.0:
        return points[0]
    for i in range(1, len(points)):
        seg = sub(points[i], points[i - 1])
        seg_len = length(seg)
        if dis > seg_len:
            dis -= seg_len
        else:
            return add(points[i - 1], mul(seg, dis / seg_len))
    return points[-1]


def direction_by_distance(points: List[Point], dis: float) -> Point:
    remain = dis
    for i in range(len(points) - 1):
        seg = sub(points[i + 1], points[i])
        seg_len = length(seg)
        if remain < seg_len:
            return unit(seg)
        remain -= seg_len
    return unit(sub(points[-1], points[-2]))
