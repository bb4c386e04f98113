"""Carry state and tables across from the JAX package.

The JAX package's RingState leaves and ring tables, given as numpy arrays
(no JAX needed here), become the port's tensors, so a test can start the
port from JAX's exact state and compare the next step.
"""

import numpy as np
import torch

from cityflow_tpu_torch.compiler.ring_net import index_tables
from cityflow_tpu_torch.core.ring import (
    BOOL_FIELDS, FLOAT_FIELDS, STATE_FIELDS, RingState, ring_constants)

# one-hot operators and TPU shift plans: the port gathers through
# index_tables instead, so these stay on the host
HOST_ONLY = frozenset({
    "E_el", "E_start", "E_end", "E_rl", "E_out", "E_app", "foe_perm",
    "fwd_gid", "fwd_res_j", "fwd_res_src", "bwd_gid", "bwd_res_j",
    "bwd_res_src", "inn_gid", "inn_res_j", "inn_res_src", "out_gid",
    "out_res_j", "out_res_src"})


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dt = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dt = torch.int32
    else:
        dt = torch.float32
    return torch.as_tensor(a, device=device).to(dt).contiguous()


def tables_from_numpy(tb, device, cfg):
    """Ring tables (numpy, from either package's build_ring) -> the port's
    device tables, with the gather index tables added when missing and
    the config's float32 constants as "ring_f32"."""
    tb = dict(tb)
    if "start_src" not in tb:
        tb.update(index_tables(tb, cfg.type_ranges, cfg.G, cfg.I))
    out = {k: _tensor(v, device) for k, v in tb.items()
           if k not in HOST_ONLY}
    out["ring_f32"] = ring_constants(cfg, device)
    return out


def ring_state_from_numpy(leaves, device) -> RingState:
    """{field: array} of a JAX RingState (single env or trailing batch)
    -> the port's RingState, in the port's dtypes (i32 / f32 / bool; JAX
    runs with x64 in the tests, where some scalars come back 64-bit)."""
    out = {}
    for k in STATE_FIELDS:
        a = np.asarray(leaves[k])
        if k in BOOL_FIELDS:
            a = a.astype(np.bool_)
        elif k in FLOAT_FIELDS:
            a = a.astype(np.float32)
        else:
            a = a.astype(np.int32)
        out[k] = torch.as_tensor(a, device=device).contiguous()
    return RingState(**out)


MID_BOOL = frozenset({"k_fail", "ap_fail", "ap_red"})
MID_INT = frozenset({"k_fffoe", "ap_ffo", "ov"})


def mid_from_numpy(mid, device):
    """The `mid` dict of JAX's ring_step_p1 -> the port's."""
    out = {}
    for k, v in mid.items():
        a = np.asarray(v)
        if k in MID_BOOL:
            a = a.astype(np.bool_)
        elif k in MID_INT:
            a = a.astype(np.int32)
        else:
            a = a.astype(np.float32)
        out[k] = torch.as_tensor(a, device=device).contiguous()
    return out
