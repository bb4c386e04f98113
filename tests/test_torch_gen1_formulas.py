"""The speed-model formulas in float64 (the gen-1 step) and float32 (the
ring): a Python float argument takes the dtype of the tensor beside it,
so an f64 formula stays f64 and equals the reference's double arithmetic
(Python floats, one IEEE op at a time), while the ring's f32 results are
the ones the formulas gave when every Python float became an f32 tensor."""

import math

import numpy as np
import pytest
import torch

from cityflow_tpu_torch.core import step as ts

rng = np.random.default_rng(7)
N = 2000
SPEED = rng.uniform(0.0, 17.0, N)
VL = rng.uniform(0.0, 17.0, N)
GAP = rng.uniform(-5.0, 120.0, N)
DIST = rng.uniform(-20.0, 150.0, N)
DEC = rng.choice([2.5, 4.5, 3.7], N)
ACC = rng.choice([2.0, 2.5, 3.1], N)
TARGET = rng.choice([16.67, 8.3333, 11.0], N)
MINGAP = rng.choice([2.5, 2.0], N)


def _ref_ncs(vL, dL, vF, dF, gap, interval, tg):
    """vehicle.cpp:200-209 in Python floats."""
    c = vF * interval / 2 + tg - 0.5 * vL * vL / dL - gap
    a = 0.5 / dF
    b = 0.5 * interval
    disc = b * b - 4 * a * c
    v1 = 0.5 / a * (math.sqrt(max(disc, 0.0)) - b)
    v2 = 2 * vL - dL * interval + 2 * (gap - tg) / interval
    return -100.0 if b * b < 4 * a * c else min(v1, v2)


def _ref_reach(speed, distance, target, acc, interval):
    """vehicle.cpp:252-282 in Python floats (getReachSteps)."""
    if distance <= 0:
        return 0
    if speed > target:
        return math.ceil(distance / (speed if speed > 0 else 1.0))
    if target <= speed:
        dts = 0.0
    else:
        s1 = math.floor((target - speed) / acc / interval)
        v1 = speed + s1 * acc / interval
        dts = (speed + v1) * (s1 * interval) / 2 + (
            (v1 + target) * interval / 2 if v1 < target else 0.0)
    if dts > distance:
        return math.ceil((math.sqrt(max(speed * speed + 2 * acc * distance,
                                        0.0)) - speed) / acc / interval)
    return (math.ceil((target - speed) / acc / interval)
            + math.ceil((distance - dts) / target / interval))


def test_f64_formulas_stay_f64_and_match_double_arithmetic():
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    dt = t(1.0)
    got = ts.no_collision_speed(t(VL), t(DEC), t(SPEED), t(DEC), t(GAP), dt,
                                t(MINGAP))
    assert got.dtype == torch.float64
    want = [_ref_ncs(*args, 1.0, m) for *args, m in zip(
        VL, DEC, SPEED, DEC, GAP, MINGAP)]
    assert got.tolist() == want
    reach = ts.reach_steps(t(SPEED), t(DIST), t(TARGET), t(ACC), dt)
    assert reach.dtype == torch.int32
    assert reach.tolist() == [_ref_reach(*a, 1.0) for a in zip(
        SPEED, DIST, TARGET, ACC)]


def test_f32_formulas_unchanged_by_the_weak_scalar_rule():
    """Python floats beside f32 tensors are f32 scalars, as before."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    args = (t(VL), t(DEC), t(SPEED), t(DEC), t(GAP))
    got = ts.no_collision_speed(*args, 1.0, 2.5)
    want = ts.no_collision_speed(*args, f32(1.0), f32(2.5))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert ts._t(0.5, t([1.0])).dtype == torch.float32
    assert ts._t(0.5, torch.zeros(1, dtype=torch.float64)).dtype \
        == torch.float64


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sqrt_is_correctly_rounded_on_the_cpu(dtype):
    x = rng.uniform(0.0, 1e4, 100_000)
    got = ts._sqrt(torch.as_tensor(x, dtype=dtype))
    if dtype == torch.float64:
        assert np.array_equal(got.numpy(), np.sqrt(x))
    else:
        # float32 keeps torch.sqrt: the ring's results stay as they were
        assert torch.equal(got, torch.sqrt(torch.as_tensor(x, dtype=dtype)))
