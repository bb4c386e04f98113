"""G9 blocker_cycles: the gen-1 step's deadlock test along the committed
blocker chains (csrc/blocker_cycles.cu).

blocker (B, V) i32 for B envs (one env is B = 1; each row its own
graph over its env's slots), is a functional graph (each slot blocked by
at most one other slot, -1 for none). Returns bool of blocker's shape:
f^S(v) >= 0, the walk from v still alive after S steps, with S the first
power of two >= limit; limit
is V in exact mode (then: a cycle is reachable from v) and
min(V, 2^min(k_chase, 10)) in fast mode, which caps the walk (a deeper
gridlock's release waits a step). The JAX package's blocker_cycles
(core/step.py:597-615) in both modes.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import egat
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_fast = 0      # fast-mode launches among them


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in ("blocker", "out")]
                + [(n, ctypes.c_longlong) for n in ("B", "V", "S", "exact")])


def walk_steps(V, exact, k_chase):
    """S: the steps the JAX package's doubling loop takes (1, 2, 4, ...
    while below the limit)."""
    limit = V if exact else min(V, 1 << min(k_chase, 10))
    steps = 1
    while steps < limit:
        steps *= 2
    return steps


def blocker_cycles_plain(blocker, exact, k_chase):
    """Plain PyTorch version: JAX's pointer doubling, one gather per
    squaring (each env's walk within its own row)."""
    S = walk_steps(blocker.shape[-1], exact, k_chase)
    f = blocker
    steps = 1
    while steps < S:
        f = torch.where(f >= 0, egat(f, f), -1)
        steps *= 2
    return f >= 0


def blocker_cycles(blocker, exact, k_chase):
    """G9 on CUDA tensors, the plain version on CPU tensors."""
    cpu = blocker.device.type == "cpu"
    _lib.check_args("blocker_cycles", blocker, dtypes=[(torch.int32,)],
                    cuda=not cpu)
    if blocker.dim() != 2:
        raise ValueError("blocker_cycles: blocker must be (B, V)")
    if cpu:
        return blocker_cycles_plain(blocker, exact, k_chase)
    return _launch(blocker, exact, k_chase)


def _launch(blocker, exact, k_chase):
    global launches, launches_fast
    B, V = blocker.shape
    out = torch.empty(blocker.shape, dtype=torch.bool, device=blocker.device)
    a = _Args(blocker.data_ptr(), out.data_ptr(), B, V,
              walk_steps(V, exact, k_chase), int(bool(exact)))
    _lib.check(_lib.lib().blocker_cycles(ctypes.byref(a),
                                         _lib.stream_ptr(blocker)),
               "blocker_cycles")
    launches += 1
    launches_fast += int(not exact)
    return out
