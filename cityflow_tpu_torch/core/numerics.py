"""Where PyTorch and XLA disagree on a primitive, the port reproduces XLA.

* float -> int32: XLA saturates (and maps NaN to 0); a PyTorch cast is
  undefined out of range and gives INT_MIN on x86 and on the card.
* jnp.take: a negative index wraps once, an index out of range gives the
  fill (NaN for floats, INT_MIN for ints); index_select raises.

Also the ring slot shift that core/ring.py and core/ring_lc.py share.
"""

import torch

INT32_MIN = -2**31
INT32_MAX = 2**31 - 1


def xla_f32_to_i32(x):
    """XLA's convert(f32 -> s32): clamp to the int32 range, NaN -> 0,
    truncate toward zero."""
    hi = x >= 2147483648.0
    lo = x < -2147483648.0
    nan = torch.isnan(x)
    y = torch.where(hi | lo | nan, torch.zeros_like(x), x).to(torch.int32)
    y = torch.where(hi, torch.full_like(y, INT32_MAX), y)
    return torch.where(lo, torch.full_like(y, INT32_MIN), y)


def jnp_take(a, idx):
    """jnp.take(a, idx) on a 1-D tensor with JAX's default mode: a
    negative index counts from the end, anything still out of range
    returns NaN (floats) / INT_MIN (ints) / True (bools)."""
    n = a.shape[0]
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    got = a[i.clamp(0, max(n - 1, 0))]
    if a.dtype.is_floating_point:
        fill = torch.full_like(got, float("nan"))
    elif a.dtype == torch.bool:
        fill = torch.ones_like(got)
    else:
        fill = torch.full_like(got, torch.iinfo(a.dtype).min)
    return torch.where(ok, got, fill)


def shift_in(first, x):
    """Leader view of a ring: [first, x[0], ..., x[S-2]] along the slots."""
    return torch.cat([first, x[:-1]], dim=0)
