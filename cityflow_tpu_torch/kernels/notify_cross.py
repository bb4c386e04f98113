"""G3 notify_cross: the notifier of every lanelink cross slot and its
Cross::canPass terms (csrc/notify_cross.cu).

For B envs at once (one env is B = 1): every per-env input has a
leading env axis B (slots local to their env), and so has every output.
Returns the own-side tables, each (B, LL, KC) in link-major layout: exists,
yield, cleared, cyc, dpos (bool), dist (f64, the cross distance minus the
notifier's front position), reach, ent, pri, idx (i32: reach steps, the
notifier's lanelink entry time, priority and slot, -1 for none).
core/step.foe_view permutes them to the foe side through
lnk_cross_foe_pos, which is the JAX package's result; G4 reads the foe
side through the same table.

Inputs: `net` (device tables lnk_cross_d, drv_len, ll_end, ll_start,
ll_is_turn, cross_ll, interval), `arr` from G1 with the packs (last_of,
first_of, link_veh, link_fattr, link_iattr), veh_next (B, V) i32,
ll_avail (B, LL) bool, fattrs (B, V, 10) f64, iattrs (B, V, 2) i32, L
lanes. In fast mode
every f64 above is float32 (one float dtype per call).
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import (
    A_CYC, A_DIS, A_LEN, A_MAXNEG, A_MAXSPD, A_PREV, A_SPEED, A_TURNSPD,
    A_UPA, A_YIELD, can_yield, egat, gat, reach_steps)
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_f32 = 0       # float32 (fast-mode) launches among them
I32_MAX = 2 ** 31 - 1
OWN = ("exists", "yield", "cleared", "cyc", "dpos", "dist", "reach", "ent",
       "pri", "idx")
_BOOL = ("exists", "yield", "cleared", "cyc", "dpos")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "d", "drv_len", "ll_end", "ll_start", "ll_is_turn", "last_of",
        "first_of", "veh_next", "ll_avail", "fattrs", "iattrs", "link_veh",
        "link_fattr", "link_iattr", "interval", "exists", "yld", "cleared",
        "cyc", "dpos", "dist", "reach", "ent", "pri", "idx")]
        + [(n, ctypes.c_int) for n in (
            "B", "LL", "KC", "K", "NA", "NI", "V", "L", "D", "fp32")])


def _empty(lead, LL, KC, f, dev):
    """No crosses in the net: no notifier anywhere."""
    shape = tuple(lead) + (LL, KC)
    out = {k: torch.zeros(shape, dtype=torch.bool, device=dev)
           for k in _BOOL}
    out["dist"] = torch.zeros(shape, dtype=f, device=dev)
    for k in ("reach", "ent", "pri"):
        out[k] = torch.zeros(shape, dtype=torch.int32, device=dev)
    out["idx"] = torch.full(shape, -1, dtype=torch.int32, device=dev)
    return out


def notify_cross_plain(net, arr, veh_next, ll_avail, fattrs, iattrs, L):
    """Plain PyTorch version: the JAX package's K2-round where-chain in
    (..., LL, KC) layout, the winner's pack fetched with a gather (the
    einsum of a one-hot row holds one term)."""
    d = net["lnk_cross_d"]                               # (LL, KC)
    LL, KC = d.shape
    B = veh_next.shape[0]
    dev = d.device
    ll_len = net["drv_len"][L:L + LL]
    fA, iA, lv = arr["link_fattr"], arr["link_iattr"], arr["link_veh"]
    per_link = lambda t: t.expand(B, LL)
    last_slot = egat(arr["last_of"], per_link(net["ll_end"]))
    last_fa, last_ia = egat(fattrs, last_slot), egat(iattrs, last_slot)
    first_slot = egat(arr["first_of"], per_link(net["ll_start"]))
    first_fa, first_ia = egat(fattrs, first_slot), egat(iattrs, first_slot)
    first_next = egat(veh_next, first_slot)
    start_len = gat(net["drv_len"], net["ll_start"])

    fa_stack = torch.cat([last_fa[:, :, None], fA, first_fa[:, :, None]], 2)
    p_stack = torch.cat([(ll_len + last_fa[..., A_DIS])[..., None],
                         fA[..., A_DIS],
                         (-(start_len - first_fa[..., A_DIS]))[..., None]],
                        2)
    v_stack = torch.cat([last_slot[..., None], lv, first_slot[..., None]], 2)
    ia_stack = torch.cat([last_ia[:, :, None], iA, first_ia[:, :, None]], 2)
    l_drv = L + torch.arange(LL, dtype=torch.int32, device=dev)
    e_ok = (last_slot >= 0) & (last_fa[..., A_PREV].to(torch.int32) == l_drv)
    t_e = ll_len + last_fa[..., A_DIS] - last_fa[..., A_LEN]
    tails = fA[..., A_DIS] - fA[..., A_LEN]
    s_ok = (first_slot >= 0) & (first_next == l_drv) & ll_avail

    K2 = fA.shape[2] + 2
    shape = (B, LL, KC)
    best_p = torch.full(shape, -1e30, dtype=d.dtype, device=dev)
    best_k = torch.zeros(shape, dtype=torch.int64, device=dev)
    best_v = torch.full(shape, -1, dtype=torch.int32, device=dev)
    best_ent = torch.zeros(shape, dtype=torch.int32, device=dev)
    best_pri = torch.zeros(shape, dtype=torch.int32, device=dev)
    for k in range(K2):
        if k == 0:
            el = e_ok[..., None] & (t_e[..., None] < d)
        elif k == K2 - 1:
            el = s_ok[..., None].expand(shape)
        else:
            el = (lv[..., k - 1] >= 0)[..., None] & (
                tails[..., k - 1][..., None] <= d)
        pk = p_stack[..., k][..., None]
        better = el & (pk > best_p)
        best_p = torch.where(better, pk, best_p)
        best_k = torch.where(better, k, best_k)
        best_v = torch.where(better, v_stack[..., k][..., None], best_v)
        best_ent = torch.where(better, ia_stack[..., k, 0][..., None],
                               best_ent)
        best_pri = torch.where(better, ia_stack[..., k, 1][..., None],
                               best_pri)
    best_fa = torch.gather(
        fa_stack, 2, best_k[..., None].expand(shape + (fa_stack.shape[3],)))

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


def offsets_fit(B, V, NA, LL, K, KC, D):
    """The kernel's offsets are 32-bit: B * V * NA (the packs), B * LL * K
    * NA (the link table), B * LL * KC (the outputs) and B * D must fit,
    or this raises (the CPU path too, so that the tests see the
    refusal)."""
    if max(B * V * NA, B * LL * K * NA, B * LL * KC, B * D) > I32_MAX:
        raise ValueError(f"notify_cross: B={B} V={V} NA={NA} LL={LL} K={K} "
                         f"KC={KC} D={D} do not fit the kernel's 32-bit "
                         "offsets")


def notify_cross(net, arr, veh_next, ll_avail, fattrs, iattrs, L):
    """G3 on CUDA tensors, the plain version on CPU tensors."""
    d = net["lnk_cross_d"]
    LL, KC = d.shape
    dev = d.device
    lead = tuple(veh_next.shape[:-1])
    if net["cross_ll"].shape[0] == 0:
        return _empty(lead, LL, KC, d.dtype, dev)
    cpu = dev.type == "cpu"
    i32, f64, b8 = (torch.int32,), _lib.FLOATS, (torch.bool,)
    ins = (d, net["drv_len"], net["ll_end"], net["ll_start"],
           net["ll_is_turn"], arr["last_of"], arr["first_of"], veh_next,
           ll_avail, fattrs, iattrs, arr["link_veh"], arr["link_fattr"],
           arr["link_iattr"], net["interval"])
    _lib.check_args("notify_cross", *ins,
                    dtypes=[f64, f64, i32, i32, b8, i32, i32, i32, b8, f64,
                            i32, i32, f64, i32, f64], cuda=not cpu)
    if len(lead) != 1:
        raise ValueError("notify_cross: veh_next must be (B, V)")
    K = arr["link_veh"].shape[-1]
    if tuple(arr["link_veh"].shape) != lead + (LL, K) \
            or tuple(arr["link_fattr"].shape[:-1]) != lead + (LL, K) \
            or tuple(ll_avail.shape) != lead + (LL,) \
            or tuple(fattrs.shape[:-2]) != lead:
        raise ValueError("notify_cross: link tables must be (..., LL, "
                         f"k_link, .) and ll_avail (..., LL), LL = {LL}, "
                         "with veh_next's env axis")
    offsets_fit(lead[0], fattrs.shape[1], fattrs.shape[-1], LL, K, KC,
                arr["last_of"].shape[-1])
    if cpu:
        return notify_cross_plain(net, arr, veh_next, ll_avail, fattrs,
                                  iattrs, L)
    return _launch(ins, LL, KC, K, L)


def _launch(ins, LL, KC, K, L):
    global launches, launches_f32
    fp32 = _lib.fp32("notify_cross", *ins)
    d, fattrs, iattrs = ins[0], ins[9], ins[10]
    B, V = fattrs.shape[0], fattrs.shape[1]
    dev = d.device
    out = {k: torch.empty((B, LL, KC), dtype=torch.bool, device=dev)
           for k in _BOOL}
    out["dist"] = torch.empty((B, LL, KC), dtype=d.dtype, device=dev)
    for k in ("reach", "ent", "pri", "idx"):
        out[k] = torch.empty((B, LL, KC), dtype=torch.int32, device=dev)
    a = _Args(*(t.data_ptr() for t in ins),
              *(out[k].data_ptr() for k in OWN),
              B, LL, KC, K, fattrs.shape[-1], iattrs.shape[-1], V, L,
              ins[5].shape[-1], fp32)
    _lib.check(_lib.lib().notify_cross(ctypes.byref(a), _lib.stream_ptr(d)),
               "notify_cross")
    launches += 1
    launches_f32 += fp32
    return out
