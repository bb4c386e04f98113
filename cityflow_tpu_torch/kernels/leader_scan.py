"""G2 leader_scan: the gen-1 leader scan past a vehicle's drivable
(csrc/leader_scan.cu).

Over B envs' slots (B, V) (one env is B = 1), with the env axis on
every per-slot input and on last_of, and slot indices local to their
env. For the slots in `mask` bool: walk up to k_scan drivables of
the vehicle's route and return (found, gap): the first rear vehicle met
(on a lanelink, the closest rear vehicle of all lanelinks leaving its
start lane) and its gap, dis_rem + dis - len, left to right; found is -1
(gap 0) where the walk meets none. Slots: drv, route, route_pos (i32),
dis, params (..., V, 12); last_of (..., D) i32; `net` holds the device
tables (drv_len, ll_start, ll_end, lane_out, lane_local, route_next_ll,
interval); L lanes.
The floats are float64 (exact mode) or float32 (fast mode), one dtype per
call.

fast=True is the JAX package's fast branch (core/step.py:262-286,
:311-314): a per-drivable table (candidate, dis - len) built once, a
lane's rear vehicle, or for a lanelink the rear vehicle with the least
dis - len over the lanelinks leaving its start lane (strict <, the first
wins), then one table read per hop, gap = dis_rem + (dis - len). It
rounds differently from the exact branch's (dis_rem + dis) - len, and
where two lanelinks' rear vehicles tie up to that rounding it may pick the
other one: the JAX package's documented fast-mode delta.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import (
    P_LEN, P_MAXSPEED, P_USUALNEGACC, chain_step, egat, gat,
    leader_scan_bound)
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_f32 = 0       # float32 launches among them
launches_fast = 0      # fast-branch launches among them
TABLES = ("drv_len", "ll_start", "ll_end", "lane_out", "lane_local",
          "route_next_ll", "interval")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "mask", "drv", "route", "route_pos", "dis", "params", "last_of")
        + TABLES + ("found", "gap", "cand_i", "cand_v")]
        + [(n, ctypes.c_longlong) for n in (
            "B", "V", "L", "D", "KO", "NR", "RLEN", "MAXLPR", "k_scan", "NP",
            "fast", "fp32")])


def cand_table_plain(dis, veh_len, last_of, net, L):
    """The fast branch's per-drivable (candidate, dis - len): (..., D) i32
    and (..., D) floats, line by line as JAX builds cand_pack (a drivable
    with no candidate holds -1 and a value nothing reads)."""
    B = dis.shape[0]
    fpack = torch.stack([dis, veh_len], dim=-1)
    lane_cand = last_of[:, :L]
    la = egat(fpack, lane_cand)
    lane_val = la[..., 0] - la[..., 1]
    outs = gat(net["lane_out"], net["ll_start"])
    LL = outs.shape[0]
    bc = torch.full((B, LL), -1, dtype=torch.int32, device=dis.device)
    bv = torch.zeros((B, LL), dtype=dis.dtype, device=dis.device)
    for k in range(outs.shape[1]):
        ol = outs[:, k].expand(B, LL)
        cand = torch.where(ol >= 0, egat(last_of, ol), -1)
        ca = egat(fpack, cand)
        val = ca[..., 0] - ca[..., 1]
        better = (cand >= 0) & ((bc < 0) | (val < bv))
        bv = torch.where(better, val, bv)
        bc = torch.where(better, cand, bc)
    return torch.cat([lane_cand, bc], -1), torch.cat([lane_val, bv], -1)


def leader_scan_plain(mask, drv, route, route_pos, dis, params, last_of, net,
                      L, k_scan, fast=False):
    """Plain PyTorch version: the JAX package's exact or fast branch, every
    hop over every slot of every env."""
    bound = leader_scan_bound(params[..., P_MAXSPEED],
                              params[..., P_USUALNEGACC], net["interval"])
    drv_len = net["drv_len"]
    veh_len = params[..., P_LEN]
    cur, pos = drv, route_pos
    dis_rem = gat(drv_len, drv) - dis
    found = torch.full_like(drv, -1)
    fgap = torch.zeros_like(dis)
    done = ~mask
    if fast:
        cand_i, cand_v = cand_table_plain(dis, veh_len, last_of, net, L)
    for _ in range(k_scan):
        nd, pos = chain_step(net, L, route, pos, cur)
        done = done | (nd < 0)
        if fast:
            cand = egat(cand_i, nd)
            cgap = dis_rem + egat(cand_v, nd)
        else:
            cand, cgap = _exact_hop(nd, dis_rem, dis, veh_len, last_of,
                                    net, L)
        hit = ~done & (cand >= 0)
        found = torch.where(hit, cand, found)
        fgap = torch.where(hit, cgap, fgap)
        done = done | hit
        dis_rem = dis_rem + gat(drv_len, nd)
        done = done | (dis_rem > bound)
        cur = nd
    return found, fgap


def _exact_hop(nd, dis_rem, dis, veh_len, last_of, net, L):
    """The exact branch's candidate and gap at the next drivable nd."""
    best_cand = torch.full_like(nd, -1)
    best_gap = torch.zeros_like(dis_rem)
    outs = gat(net["lane_out"], gat(net["ll_start"], nd - L))
    for k in range(outs.shape[-1]):
        ol = outs[..., k]
        cand = torch.where(ol >= 0, egat(last_of, ol), -1)
        cgap = dis_rem + egat(dis, cand) - egat(veh_len, cand)
        better = (cand >= 0) & ((best_cand < 0) | (cgap < best_gap))
        best_gap = torch.where(better, cgap, best_gap)
        best_cand = torch.where(better, cand, best_cand)
    lane_cand = egat(last_of, nd)
    lane_gap = dis_rem + egat(dis, lane_cand) - egat(veh_len, lane_cand)
    is_ll = nd >= L
    return (torch.where(is_ll, best_cand, lane_cand),
            torch.where(is_ll, best_gap, lane_gap))


def leader_scan(mask, drv, route, route_pos, dis, params, last_of, net, L,
                k_scan, fast=False):
    """G2 on CUDA tensors, the plain version on CPU tensors."""
    cpu = mask.device.type == "cpu"
    i32, f = (torch.int32,), _lib.FLOATS
    tabs = [net[k] for k in TABLES]
    _lib.check_args("leader_scan", mask, drv, route, route_pos, dis, params,
                    last_of, *tabs,
                    dtypes=[(torch.bool,), i32, i32, i32, f, f, i32,
                            f, i32, i32, i32, i32, i32, f],
                    cuda=not cpu)
    fp32 = _lib.fp32("leader_scan", dis, params, *tabs)
    lead = tuple(mask.shape)
    if len(lead) != 2:
        raise ValueError(f"leader_scan: mask {lead} is not (B, V)")
    for i, t in enumerate((drv, route, route_pos, dis)):
        if tuple(t.shape) != lead:
            raise ValueError(f"leader_scan: input {i + 1} {tuple(t.shape)}"
                             f" != {lead}")
    if params.dim() != len(lead) + 1 or tuple(params.shape[:-1]) != lead:
        raise ValueError(f"leader_scan: params must be {lead + ('NP',)}")
    if tuple(last_of.shape[:-1]) != lead[:-1]:
        raise ValueError("leader_scan: last_of needs the env axis of mask")
    if cpu:
        return leader_scan_plain(mask, drv, route, route_pos, dis, params,
                                 last_of, net, L, k_scan, fast)
    return _launch(mask, drv, route, route_pos, dis, params, last_of, net,
                   L, k_scan, fast, fp32)


def _launch(mask, drv, route, route_pos, dis, params, last_of, net, L,
            k_scan, fast, fp32):
    global launches, launches_f32, launches_fast
    B, V = mask.shape
    D = last_of.shape[-1]
    tabs = [net[k] for k in TABLES]
    found = torch.empty((B, V), dtype=torch.int32, device=mask.device)
    gap = torch.empty((B, V), dtype=dis.dtype, device=mask.device)
    cand_i = torch.empty((B, D) if fast else 0, dtype=torch.int32,
                         device=mask.device)
    cand_v = torch.empty((B, D) if fast else 0, dtype=dis.dtype,
                         device=mask.device)
    NR, RLEN, MAXLPR = net["route_next_ll"].shape
    a = _Args(*(t.data_ptr() for t in (
        mask, drv, route, route_pos, dis, params, last_of, *tabs, found,
        gap, cand_i, cand_v)), B, V, L, D, net["lane_out"].shape[1], NR,
        RLEN, MAXLPR, k_scan, params.shape[-1], int(fast), fp32)
    _lib.check(_lib.lib().leader_scan(ctypes.byref(a), _lib.stream_ptr(dis)),
               "leader_scan")
    launches += 1
    launches_f32 += fp32
    launches_fast += int(fast)
    return found, gap
