"""The port's speed-model helpers and XLA-compatibility primitives against
the JAX package, on the CPU.

Inputs are float32 numpy arrays from a seed, with 0, negative, huge and
infinite values mixed in. Integer outputs must be equal; float outputs
within rtol 1e-6 (NaN where JAX gives NaN)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cityflow_tpu.core import step as jax_step

from cityflow_tpu_torch.core import step
from cityflow_tpu_torch.core.numerics import jnp_take, xla_f32_to_i32

torch.set_num_threads(2)

SPECIAL = np.array([0.0, -0.0, -1.0, -37.5, 1e-7, 1e30, -1e30, np.inf,
                    -np.inf, 3e9], np.float32)


def _inputs(n_args, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_args):
        a = rng.uniform(-5.0, 40.0, n).astype(np.float32)
        k = rng.choice(n, len(SPECIAL) * 8, replace=False)
        a[k] = np.tile(SPECIAL, 8)
        out.append(a)
    return out


def _positive(a, seed):
    """Accelerations and time steps: positive, from the scenario range."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 6.0, a.shape).astype(np.float32)


def _check(want, got):
    want = np.asarray(want)
    got = got.numpy()
    if np.issubdtype(want.dtype, np.integer) or want.dtype == np.bool_:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float32).astype(np.float64),
                                   rtol=1e-6, atol=0, equal_nan=True)


CASES = {
    # name: (argument count, indices of positive-only arguments)
    "no_collision_speed": (7, (1, 3, 5)),
    "brake_distance_after_accel": (4, (1, 2, 3)),
    "stop_before_speed": (5, (1, 2, 4)),
    "distance_until_speed": (4, (2, 3)),
    "reach_steps": (5, (3, 4)),
    "can_yield": (5, (1,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_speed_model_matches_jax(name):
    n_args, pos = CASES[name]
    args = _inputs(n_args, seed=len(name))
    for i in pos:
        args[i] = _positive(args[i], seed=i)
    # each side gets its own copy of the inputs, and JAX's asynchronous
    # result is read back before the port runs: no buffer is shared
    want = np.asarray(getattr(jax_step, name)(*[jnp.array(a) for a in args]))
    got = getattr(step, name)(*[torch.tensor(a) for a in args])
    if name == "reach_steps":
        assert got.dtype == torch.int32
    _check(want, got)


def test_float_to_int32_cast_saturates_like_xla():
    x = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.0**31, -2.0**31,
                  2147483520.0, -2.5, 2.5, 0.0, 1e-30], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = xla_f32_to_i32(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    # the ring's empty link slots: f32(INT_MAX) = 2^31 comes back as INT_MAX
    assert int(xla_f32_to_i32(torch.tensor([2**31 - 1],
                                           dtype=torch.float32))[0]) \
        == 2**31 - 1


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
def test_take_matches_jnp_take(dtype):
    a = (np.arange(7) % 3 == 0).astype(dtype) if dtype == np.bool_ \
        else np.arange(7).astype(dtype) * 3
    idx = np.array([-9, -8, -7, -1, 0, 3, 6, 7, 100], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(a), jnp.asarray(idx)))
    got = jnp_take(torch.from_numpy(a), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_division_by_a_constant_is_within_one_ulp_of_jit():
    """XLA rewrites x / c for a compile-time constant c into x * (1 / c);
    the port divides. The two differ by at most one ulp, and the port's
    helpers equal JAX's bitwise when the divisor is a runtime value."""
    x = _inputs(1, seed=7)[0]
    x = x[np.isfinite(x)]
    jit = np.asarray(jax.jit(lambda v: 0.5 * v * v / jnp.float32(4.5))(x))
    t = torch.from_numpy(x)
    got = (0.5 * t * t / torch.tensor(4.5)).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - jit.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1
    rt = np.asarray(jax.jit(lambda v, c: 0.5 * v * v / c)(x,
                                                         np.float32(4.5)))
    np.testing.assert_array_equal(got, rt)
