"""G3 notify_cross: the notifier of every lanelink cross slot and its
Cross::canPass terms (csrc/notify_cross.cu).

Returns the own-side tables, each (LL, KC) in link-major layout: exists,
yield, cleared, cyc, dpos (bool), dist (f64, the cross distance minus the
notifier's front position), reach, ent, pri, idx (i32: reach steps, the
notifier's lanelink entry time, priority and slot, -1 for none).
core/step.foe_view permutes them to the foe side through
lnk_cross_foe_pos, which is the JAX package's result; G4 reads the foe
side through the same table.

Inputs: `net` (device tables lnk_cross_d, drv_len, ll_end, ll_start,
ll_is_turn, cross_ll, interval), `arr` from G1 with the packs (last_of,
first_of, link_veh, link_fattr, link_iattr), veh_next (V,) i32, ll_avail
(LL,) bool, fattrs (V, 10) f64, iattrs (V, 2) i32, L lanes. In fast mode
every f64 above is float32 (one float dtype per call).
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import (
    A_CYC, A_DIS, A_LEN, A_MAXNEG, A_MAXSPD, A_PREV, A_SPEED, A_TURNSPD,
    A_UPA, A_YIELD, can_yield, gat, reach_steps)
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_f32 = 0       # float32 (fast-mode) launches among them
OWN = ("exists", "yield", "cleared", "cyc", "dpos", "dist", "reach", "ent",
       "pri", "idx")
_BOOL = ("exists", "yield", "cleared", "cyc", "dpos")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "d", "drv_len", "ll_end", "ll_start", "ll_is_turn", "last_of",
        "first_of", "veh_next", "ll_avail", "fattrs", "iattrs", "link_veh",
        "link_fattr", "link_iattr", "interval", "exists", "yld", "cleared",
        "cyc", "dpos", "dist", "reach", "ent", "pri", "idx")]
        + [(n, ctypes.c_longlong) for n in (
            "LL", "KC", "K", "NA", "NI", "V", "L", "fp32")])


def _empty(LL, KC, f, dev):
    """No crosses in the net: no notifier anywhere."""
    out = {k: torch.zeros((LL, KC), dtype=torch.bool, device=dev)
           for k in _BOOL}
    out["dist"] = torch.zeros((LL, KC), dtype=f, device=dev)
    for k in ("reach", "ent", "pri"):
        out[k] = torch.zeros((LL, KC), dtype=torch.int32, device=dev)
    out["idx"] = torch.full((LL, KC), -1, dtype=torch.int32, device=dev)
    return out


def notify_cross_plain(net, arr, veh_next, ll_avail, fattrs, iattrs, L):
    """Plain PyTorch version: the JAX package's K2-round where-chain in
    (LL, KC) layout, the winner's pack fetched with a gather (the einsum
    of a one-hot row holds one term)."""
    d = net["lnk_cross_d"]                               # (LL, KC)
    LL, KC = d.shape
    dev = d.device
    ll_len = net["drv_len"][L:L + LL]
    fA, iA, lv = arr["link_fattr"], arr["link_iattr"], arr["link_veh"]
    last_slot = gat(arr["last_of"], net["ll_end"])
    last_fa, last_ia = gat(fattrs, last_slot), gat(iattrs, last_slot)
    first_slot = gat(arr["first_of"], net["ll_start"])
    first_fa, first_ia = gat(fattrs, first_slot), gat(iattrs, first_slot)
    first_next = gat(veh_next, first_slot)
    start_len = gat(net["drv_len"], net["ll_start"])

    fa_stack = torch.cat([last_fa[:, None], fA, first_fa[:, None]], 1)
    p_stack = torch.cat([(ll_len + last_fa[:, A_DIS])[:, None],
                         fA[:, :, A_DIS],
                         (-(start_len - first_fa[:, A_DIS]))[:, None]], 1)
    v_stack = torch.cat([last_slot[:, None], lv, first_slot[:, None]], 1)
    ia_stack = torch.cat([last_ia[:, None], iA, first_ia[:, None]], 1)
    l_drv = L + torch.arange(LL, dtype=torch.int32, device=dev)
    e_ok = (last_slot >= 0) & (last_fa[:, A_PREV].to(torch.int32) == l_drv)
    t_e = ll_len + last_fa[:, A_DIS] - last_fa[:, A_LEN]
    tails = fA[:, :, A_DIS] - fA[:, :, A_LEN]
    s_ok = (first_slot >= 0) & (first_next == l_drv) & ll_avail

    K2 = fA.shape[1] + 2
    best_p = torch.full((LL, KC), -1e30, dtype=d.dtype, device=dev)
    best_k = torch.zeros((LL, KC), dtype=torch.int64, device=dev)
    best_v = torch.full((LL, KC), -1, dtype=torch.int32, device=dev)
    best_ent = torch.zeros((LL, KC), dtype=torch.int32, device=dev)
    best_pri = torch.zeros((LL, KC), dtype=torch.int32, device=dev)
    for k in range(K2):
        if k == 0:
            el = e_ok[:, None] & (t_e[:, None] < d)
        elif k == K2 - 1:
            el = s_ok[:, None].expand(LL, KC)
        else:
            el = (lv[:, k - 1] >= 0)[:, None] & (tails[:, k - 1][:, None]
                                                  <= d)
        pk = p_stack[:, k][:, None]
        better = el & (pk > best_p)
        best_p = torch.where(better, pk, best_p)
        best_k = torch.where(better, k, best_k)
        best_v = torch.where(better, v_stack[:, k][:, None], best_v)
        best_ent = torch.where(better, ia_stack[:, k, 0][:, None], best_ent)
        best_pri = torch.where(better, ia_stack[:, k, 1][:, None], best_pri)
    best_fa = torch.gather(
        fa_stack, 1, best_k[:, :, None].expand(LL, KC, fa_stack.shape[2]))

    ndist = d - best_p
    target = torch.where(net["ll_is_turn"][:, None], best_fa[..., A_TURNSPD],
                         best_fa[..., A_MAXSPD])
    return {
        "exists": best_v >= 0,
        "yield": can_yield(best_fa[..., A_SPEED], best_fa[..., A_MAXNEG],
                           best_fa[..., A_YIELD], best_fa[..., A_LEN], ndist),
        "cleared": ndist + best_fa[..., A_LEN] < 0,
        "cyc": best_fa[..., A_CYC] > 0,
        "dpos": ndist > 0,
        "dist": ndist,
        "reach": reach_steps(best_fa[..., A_SPEED], ndist, target,
                             best_fa[..., A_UPA], net["interval"]),
        "ent": best_ent, "pri": best_pri, "idx": best_v}


def notify_cross(net, arr, veh_next, ll_avail, fattrs, iattrs, L):
    """G3 on CUDA tensors, the plain version on CPU tensors."""
    d = net["lnk_cross_d"]
    LL, KC = d.shape
    dev = d.device
    if net["cross_ll"].shape[0] == 0:
        return _empty(LL, KC, d.dtype, dev)
    cpu = dev.type == "cpu"
    i32, f64, b8 = (torch.int32,), _lib.FLOATS, (torch.bool,)
    ins = (d, net["drv_len"], net["ll_end"], net["ll_start"],
           net["ll_is_turn"], arr["last_of"], arr["first_of"], veh_next,
           ll_avail, fattrs, iattrs, arr["link_veh"], arr["link_fattr"],
           arr["link_iattr"], net["interval"])
    _lib.check_args("notify_cross", *ins,
                    dtypes=[f64, f64, i32, i32, b8, i32, i32, i32, b8, f64,
                            i32, i32, f64, i32, f64], cuda=not cpu)
    K = arr["link_veh"].shape[1]
    if tuple(arr["link_veh"].shape) != (LL, K) \
            or tuple(arr["link_fattr"].shape[:2]) != (LL, K):
        raise ValueError("notify_cross: link tables must be (LL, k_link, .)"
                         f" with LL = {LL}")
    if cpu:
        return notify_cross_plain(net, arr, veh_next, ll_avail, fattrs,
                                  iattrs, L)
    return _launch(ins, LL, KC, K, fattrs, iattrs, L)


def _launch(ins, LL, KC, K, fattrs, iattrs, L):
    global launches, launches_f32
    fp32 = _lib.fp32("notify_cross", *ins)
    d = ins[0]
    dev = d.device
    out = {k: torch.empty((LL, KC), dtype=torch.bool, device=dev)
           for k in _BOOL}
    out["dist"] = torch.empty((LL, KC), dtype=d.dtype, device=dev)
    for k in ("reach", "ent", "pri", "idx"):
        out[k] = torch.empty((LL, KC), dtype=torch.int32, device=dev)
    a = _Args(*(t.data_ptr() for t in ins),
              *(out[k].data_ptr() for k in OWN),
              LL, KC, K, fattrs.shape[1], iattrs.shape[1], fattrs.shape[0], L,
              fp32)
    _lib.check(_lib.lib().notify_cross(ctypes.byref(a), _lib.stream_ptr(d)),
               "notify_cross")
    launches += 1
    launches_f32 += fp32
    return out
