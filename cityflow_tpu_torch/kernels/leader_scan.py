"""G2 leader_scan: the gen-1 leader scan past a vehicle's drivable
(csrc/leader_scan.cu).

For the slots in `mask` (V,) bool: walk up to k_scan drivables of the
vehicle's route and return (found, gap): the first rear vehicle met (on a
lanelink, the closest rear vehicle of all lanelinks leaving its start
lane) and its gap, dis_rem + dis - len, left to right in float64; found is
-1 (gap 0) where the walk meets none. Slots (V,): drv, route, route_pos
(i32), dis (f64), params (V, 12) f64; last_of (D,) i32; `net` holds the
device tables (drv_len, ll_start, ll_end, lane_out, lane_local,
route_next_ll, interval); L lanes.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import (
    P_LEN, P_MAXSPEED, P_USUALNEGACC, chain_step, gat, leader_scan_bound)
from cityflow_tpu_torch.kernels import _lib

launches = 0
TABLES = ("drv_len", "ll_start", "ll_end", "lane_out", "lane_local",
          "route_next_ll", "interval")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "mask", "drv", "route", "route_pos", "dis", "params", "last_of")
        + TABLES + ("found", "gap")]
        + [(n, ctypes.c_longlong) for n in (
            "V", "L", "D", "KO", "NR", "RLEN", "MAXLPR", "k_scan", "NP")])


def leader_scan_plain(mask, drv, route, route_pos, dis, params, last_of, net,
                      L, k_scan):
    """Plain PyTorch version: the JAX package's exact branch, every hop
    over every slot."""
    bound = leader_scan_bound(params[:, P_MAXSPEED], params[:, P_USUALNEGACC],
                              net["interval"])
    drv_len = net["drv_len"]
    veh_len = params[:, P_LEN]
    cur, pos = drv, route_pos
    dis_rem = gat(drv_len, drv) - dis
    found = torch.full_like(drv, -1)
    fgap = torch.zeros_like(dis)
    done = ~mask
    for _ in range(k_scan):
        nd, pos = chain_step(net, L, route, pos, cur)
        done = done | (nd < 0)
        start_lane = gat(net["ll_start"], nd - L)
        best_cand = torch.full_like(nd, -1)
        best_gap = torch.zeros_like(fgap)
        outs = gat(net["lane_out"], start_lane)
        for k in range(net["lane_out"].shape[1]):
            ol = outs[:, k]
            cand = torch.where(ol >= 0, gat(last_of, ol), -1)
            cgap = dis_rem + gat(dis, cand) - gat(veh_len, cand)
            better = (cand >= 0) & ((best_cand < 0) | (cgap < best_gap))
            best_gap = torch.where(better, cgap, best_gap)
            best_cand = torch.where(better, cand, best_cand)
        lane_cand = gat(last_of, nd)
        lane_gap = dis_rem + gat(dis, lane_cand) - gat(veh_len, lane_cand)
        is_ll = nd >= L
        cand = torch.where(is_ll, best_cand, lane_cand)
        cgap = torch.where(is_ll, best_gap, lane_gap)
        hit = ~done & (cand >= 0)
        found = torch.where(hit, cand, found)
        fgap = torch.where(hit, cgap, fgap)
        done = done | hit
        dis_rem = dis_rem + gat(drv_len, nd)
        done = done | (dis_rem > bound)
        cur = nd
    return found, fgap


def leader_scan(mask, drv, route, route_pos, dis, params, last_of, net, L,
                k_scan):
    """G2 on CUDA tensors, the plain version on CPU tensors."""
    cpu = mask.device.type == "cpu"
    i32, f64 = (torch.int32,), (torch.float64,)
    tabs = [net[k] for k in TABLES]
    _lib.check_args("leader_scan", mask, drv, route, route_pos, dis, params,
                    last_of, *tabs,
                    dtypes=[(torch.bool,), i32, i32, i32, f64, f64, i32,
                            f64, i32, i32, i32, i32, i32, f64],
                    cuda=not cpu)
    V = mask.shape[0]
    for i, t in enumerate((drv, route, route_pos, dis)):
        if tuple(t.shape) != (V,):
            raise ValueError(f"leader_scan: input {i + 1} {tuple(t.shape)}"
                             f" != {(V,)}")
    if params.dim() != 2 or params.shape[0] != V:
        raise ValueError("leader_scan: params must be (V, NP)")
    if cpu:
        return leader_scan_plain(mask, drv, route, route_pos, dis, params,
                                 last_of, net, L, k_scan)
    return _launch(mask, drv, route, route_pos, dis, params, last_of, net, L,
                   k_scan)


def _launch(mask, drv, route, route_pos, dis, params, last_of, net, L,
            k_scan):
    global launches
    V = mask.shape[0]
    tabs = [net[k] for k in TABLES]
    found = torch.empty(V, dtype=torch.int32, device=mask.device)
    gap = torch.empty(V, dtype=dis.dtype, device=mask.device)
    NR, RLEN, MAXLPR = net["route_next_ll"].shape
    a = _Args(*(t.data_ptr() for t in (
        mask, drv, route, route_pos, dis, params, last_of, *tabs, found,
        gap)), V, L, last_of.shape[0], net["lane_out"].shape[1], NR, RLEN,
        MAXLPR, k_scan, params.shape[1])
    _lib.check(_lib.lib().leader_scan(ctypes.byref(a), _lib.stream_ptr(dis)),
               "leader_scan")
    launches += 1
    return found, gap
