"""Speed-model formulas of the reference (vehicle.cpp), elementwise over
float32 tensors in the reference's operation order.

These are the plain versions of what csrc/common.cuh computes inside the
kernels; Python float arguments broadcast as float32 scalars, as JAX's
weakly typed constants do.
"""

import torch

from cityflow_tpu_torch.core.numerics import xla_f32_to_i32

EPS = 1e-8  # reference utility.h:15


def _t(x, like):
    return x if torch.is_tensor(x) else torch.tensor(
        x, dtype=torch.float32, device=like.device)


def no_collision_speed(vL, dL, vF, dF, gap, interval, target_gap):
    """reference vehicle.cpp:200-209."""
    c = vF * interval / 2 + target_gap - 0.5 * vL * vL / dL - gap
    a = 0.5 / _t(dF, c)
    b = 0.5 * _t(interval, c)
    disc = b * b - 4 * a * c
    v1 = 0.5 / a * (torch.sqrt(torch.clamp_min(disc, 0.0)) - b)
    v2 = 2 * vL - dL * interval + 2 * (gap - target_gap) / interval
    v = torch.minimum(v1, _t(v2, v1))
    return torch.where(b * b < 4 * a * c, -100.0, v)


def brake_distance_after_accel(speed, acc, dec, interval):
    """reference vehicle.cpp:302-306."""
    next_speed = speed + acc * interval
    return ((speed + next_speed) * interval / 2
            + (next_speed * next_speed / dec / 2))


def stop_before_speed(speed, usual_pos, usual_neg, distance, interval):
    """reference vehicle.cpp:240-250 (getStopBeforeSpeed)."""
    bda = brake_distance_after_accel(speed, usual_pos, usual_neg, interval)
    ti = 2 * distance / (speed + EPS) / interval
    # (int)takeInterval: C truncation; x86 cvttsd2si out of range -> INT_MIN
    ti_int = torch.where(torch.abs(ti) >= 2.0**31, -(2.0**31),
                         torch.trunc(ti))
    ge1 = speed - speed / ti_int
    lt1 = speed - speed / ti
    slow = torch.where(ti >= 1, ge1, lt1)
    return torch.where(bda < distance, speed + usual_pos * interval, slow)


def distance_until_speed(speed, target, acc, interval):
    """reference vehicle.cpp:275-282 (stage1speed adds acc/interval, as
    written there)."""
    s1 = torch.floor((target - speed) / acc / interval)
    v1 = speed + s1 * acc / interval
    d1 = (speed + v1) * (s1 * interval) / 2
    d = d1 + torch.where(v1 < target, (v1 + target) * interval / 2, 0.0)
    return torch.where(target <= speed, 0.0, d)


def reach_steps(speed, distance, target, acc, interval):
    """reference vehicle.cpp:252-268 (getReachSteps), returns int32 with
    XLA's saturating cast."""
    r_fast = torch.ceil(distance / torch.where(speed > 0, speed, 1.0))
    dts = distance_until_speed(speed, target, acc, interval)
    r_a = torch.ceil((torch.sqrt(torch.clamp_min(
        speed * speed + 2 * acc * distance, 0.0)) - speed) / acc / interval)
    r_b = (torch.ceil((target - speed) / acc / interval)
           + torch.ceil((distance - dts) / target / interval))
    r = torch.where(speed > target, r_fast,
                    torch.where(dts > distance, r_a, r_b))
    r = torch.where(distance <= 0, 0.0, r)
    return xla_f32_to_i32(r)


def can_yield(speed, max_neg, yield_dist, length, d):
    """reference vehicle.cpp:284-287."""
    min_brake = 0.5 * speed * speed / max_neg
    return (((d > 0) & (min_brake < d - yield_dist))
            | ((d < 0) & (d + length < 0)))


def leader_scan_bound(max_speed, usual_neg, interval):
    """How far ahead the leader scan looks past the drivable's end
    (reference vehicle.cpp, updateLeaderAndGap / getIntersectionRelatedSpeed:
    the brake distance at max speed plus two intervals of travel)."""
    return max_speed * max_speed / usual_neg / 2 + max_speed * interval * 2
