"""Carry state and tables across from the JAX package.

The JAX package's RingState and gen-1 SimState leaves and ring tables,
given as numpy arrays (no JAX needed here), become the port's tensors, so
a test can start the port from JAX's exact state and compare the next
step; so do the DQN's Q-network parameters. `net_tensors` puts a compiled
scenario's gen-1 tables on a device.
"""

import numpy as np
import torch

from cityflow_tpu_torch.compiler.ring_net import index_tables
from cityflow_tpu_torch.core.ring import (
    BOOL_FIELDS, FLOAT_FIELDS, OPTIONAL_FIELDS, STATE_FIELDS, RingState,
    ring_constants)
from cityflow_tpu_torch.core.state import (
    SIM_BOOL, SIM_FIELDS, SIM_FLOAT, SimState)
from cityflow_tpu_torch.rl.dqn import QParams

# the gen-1 step's static tables (the JAX package's _net_device_arrays)
NET_KEYS = (
    "drv_len", "drv_max_speed", "lane_road", "lane_local", "lane_width",
    "road_num_lanes", "lane_out", "ll_start", "ll_end", "ll_is_turn",
    "ll_type", "ll_inter", "ll_rl_local", "phase_offset", "n_phases",
    "phase_time", "phase_rl_avail", "inter_virtual", "cross_dist",
    "cross_ll", "ll_cross_idx", "ll_cross_side", "lnk_cross_d",
    "lnk_cross_valid", "lnk_cross_selfflat", "lnk_cross_foeflat",
    "lnk_cross_foetype", "lnk_cross_foe_pos", "cross_end_lane",
    "cross_start_lane", "cross_type", "cross_is_turn", "route_len",
    "route_roads", "route_next_ll", "flow_route", "flow_params",
    "flow_interval", "flow_start", "flow_end")

# one-hot operators and TPU shift plans: the port gathers through
# index_tables instead, so these stay on the host
HOST_ONLY = frozenset({
    "E_el", "E_start", "E_end", "E_rl", "E_out", "E_app", "foe_perm",
    "fwd_gid", "fwd_res_j", "fwd_res_src", "bwd_gid", "bwd_res_j",
    "bwd_res_src", "inn_gid", "inn_res_j", "inn_res_src", "out_gid",
    "out_res_j", "out_res_src"})


def _tensor(a, device, fdtype=torch.float32):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dt = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dt = torch.int32
    else:
        dt = fdtype
    return torch.as_tensor(a, device=device).to(dt).contiguous()


def net_tensors(net, dtype, device):
    """A CompiledNet's gen-1 tables on `device`: ints as int32, bools as
    bool, floats in `dtype`; "interval" is the step interval as a 0-dim
    tensor of `dtype` (the step divides by it on the device)."""
    out = {k: _tensor(getattr(net, k), device, dtype) for k in NET_KEYS}
    out["interval"] = torch.tensor(float(net.host.config["interval"]),
                                   dtype=dtype, device=device)
    return out


def sim_state_from_numpy(leaves, device, dtype=torch.float64) -> SimState:
    """{field: array} of a gen-1 SimState (the JAX package's, or a dump)
    -> the port's SimState in its dtypes: bool, int32 (JAX under x64
    returns some ints as int64) and `dtype` for floats."""
    out = {}
    for k in SIM_FIELDS:
        a = np.asarray(leaves[k])
        if k in SIM_BOOL:
            a = a.astype(np.bool_)
        elif k in SIM_FLOAT:
            a = a.astype(np.float64)
        else:
            a = a.astype(np.int32)
        t = torch.as_tensor(a, device=device)
        out[k] = (t.to(dtype) if k in SIM_FLOAT else t).contiguous()
    return SimState(**out)


def sim_state_to_numpy(st: SimState):
    """The port's SimState -> {field: numpy array}."""
    return {k: v.cpu().numpy() for k, v in st.leaves().items()}


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
    runs with x64 in the tests, where some scalars come back 64-bit). The
    lane-change and history leaves are taken when present and left None
    otherwise."""
    out = {}
    for k in STATE_FIELDS:
        if leaves.get(k) is None:
            if k in OPTIONAL_FIELDS:
                continue
            raise KeyError(f"ring_state_from_numpy: no leaf {k}")
        a = np.asarray(leaves[k])
        if k in BOOL_FIELDS:
            a = a.astype(np.bool_)
        elif k in FLOAT_FIELDS:
            a = a.astype(np.float32)
        else:
            a = a.astype(np.int32)
        out[k] = torch.as_tensor(a, device=device).contiguous()
    return RingState(**out)


def qparams_from_numpy(params, device) -> QParams:
    """The JAX package's QParams (w1, b1, w2, b2; numpy or anything
    np.asarray takes) -> the port's, float32 leaf tensors that require
    grad, in the same orientation (obs @ w1)."""
    return QParams(*(torch.tensor(np.array(getattr(params, k), np.float32),
                                  device=device, requires_grad=True)
                     for k in QParams._fields))


MID_BOOL = frozenset({"k_fail", "ap_fail", "ap_red"})
MID_INT = frozenset({"k_fffoe", "ap_ffo", "ov"})


def mid_from_numpy(mid, device):
    """The `mid` dict of JAX's ring_step_p1 -> the port's (the same keys
    with lane change on or off; a key outside MID_BOOL / MID_INT is
    float32)."""
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
