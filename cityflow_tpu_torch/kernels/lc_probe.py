"""G6 lc_probe: the neighbour probe of gen-1 lane change
(csrc/lc_probe.cu).

Inputs over the V slots: running (bool), drv (i32), dis (f64, or f32 in
fast mode); G1's
last_of (D,) and leader (V,) (i32) of the same state; `net` holds
lane_local, lane_road and road_num_lanes; L lanes. Returns a dict of (V,)
i32: outer_lane / inner_lane (the lane at local index + 1 / - 1 of a
running lane vehicle's road, L where there is none) and, on each,
<side>_leader (the vehicle with the smallest distance >= the slot's, ties
to the largest slot) and <side>_follower (the largest distance < the
slot's, ties to the smallest slot), -1 for none; distances compare in
lax.sort's total order. This is what the JAX package's stable 3V sort
gives (vehicles before probes at equal distance, slots ascending).
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import gat, order_key
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_f32 = 0       # float32 (fast-mode) launches among them
TABLES = ("lane_local", "lane_road", "road_num_lanes")
OUT = ("outer_lane", "inner_lane", "outer_leader", "outer_follower",
       "inner_leader", "inner_follower")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        ("running", "drv", "dis") + TABLES + ("last_of", "leader") + OUT)]
        + [(n, ctypes.c_longlong) for n in ("V", "L", "R", "fp32")])


def side_lanes(running, drv, net, L):
    """(outer, inner) lane of each running lane vehicle, L for none."""
    on_lane = running & (drv >= 0) & (drv < L)
    local = gat(net["lane_local"], drv)
    n_in = gat(net["road_num_lanes"], gat(net["lane_road"], drv))
    outer = torch.where(on_lane & (local + 1 < n_in), drv + 1, L)
    inner = torch.where(on_lane & (local > 0), drv - 1, L)
    return outer, inner


def _probe_plain(lane, key, last_of, leader, L):
    """Walk every probe's lane from the rear along the leader chain, all
    probes at once, keeping the best leader and follower (key: each
    slot's order key of -dis; a probe's is its own slot's)."""
    key_p = key
    cur = torch.where(lane < L, gat(last_of, lane), -1)
    bl = torch.full_like(cur, -1)
    bf = torch.full_like(cur, -1)
    kl = torch.zeros_like(key_p)
    kf = torch.zeros_like(key_p)
    while bool((cur >= 0).any()):
        has = cur >= 0
        ku = gat(key, cur)
        lead = has & (ku <= key_p) & ((bl < 0) | (ku > kl)
                                      | ((ku == kl) & (cur > bl)))
        foll = has & (ku > key_p) & ((bf < 0) | (ku < kf)
                                     | ((ku == kf) & (cur < bf)))
        bl, kl = torch.where(lead, cur, bl), torch.where(lead, ku, kl)
        bf, kf = torch.where(foll, cur, bf), torch.where(foll, ku, kf)
        cur = torch.where(has, gat(leader, cur), -1)
    return bl, bf


def lc_probe_plain(running, drv, dis, last_of, leader, net, L):
    """Plain PyTorch version: the kernel's lane walks, vectorised over
    slots."""
    outer, inner = side_lanes(running, drv, net, L)
    key = order_key(-dis)
    out = dict(outer_lane=outer, inner_lane=inner)
    for name, lane in (("outer", outer), ("inner", inner)):
        out[name + "_leader"], out[name + "_follower"] = _probe_plain(
            lane, key, last_of, leader, L)
    return out


def lc_probe(running, drv, dis, last_of, leader, net, L):
    """G6 on CUDA tensors, the plain version on CPU tensors."""
    cpu = dis.device.type == "cpu"
    i32 = (torch.int32,)
    tabs = [net[k] for k in TABLES]
    _lib.check_args("lc_probe", running, drv, dis, last_of, leader, *tabs,
                    dtypes=[(torch.bool,), i32, _lib.FLOATS, i32, i32,
                            i32, i32, i32], cuda=not cpu)
    V = dis.shape[0]
    if running.shape[0] != V or drv.shape[0] != V or leader.shape[0] != V:
        raise ValueError("lc_probe: running, drv, dis and leader must be "
                         "(V,)")
    if cpu:
        return lc_probe_plain(running, drv, dis, last_of, leader, net, L)
    return _launch(running, drv, dis, last_of, leader, tabs, L)


def _launch(running, drv, dis, last_of, leader, tabs, L):
    global launches, launches_f32
    fp32 = _lib.fp32("lc_probe", dis)
    V = dis.shape[0]
    out = {k: torch.empty(V, dtype=torch.int32, device=dis.device)
           for k in OUT}
    a = _Args(*(t.data_ptr() for t in (
        running, drv, dis, *tabs, last_of, leader, *(out[k] for k in OUT))),
        V, L, tabs[2].shape[0], fp32)
    _lib.check(_lib.lib().lc_probe(ctypes.byref(a), _lib.stream_ptr(dis)),
               "lc_probe")
    launches += 1
    launches_f32 += fp32
    return out
