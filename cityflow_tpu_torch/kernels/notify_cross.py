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
ll_is_turn, cross_ll, interval), `arr` from G1 (last_of, first_of,
sorted_idx, drv_off: lanelink ll's candidates are its first k_link
vehicles, sorted_idx[drv_off[L + ll] + r]), veh_next (B, V) i32, ll_avail
(B, LL) bool, `leaves` the state's own slot leaves (LEAVES: dis, speed
(B, V) f64, params (B, V, NP) f64, G9's cyc (B, V) bool, prev_drv,
enter_ll_time, priority (B, V) i32), L lanes, k_link. In fast mode every
f64 above is float32 (one float dtype per call). The JAX package reads
the candidates from G1's per-lanelink pack tables and compares prev_drv
cast to its float type; the port reads the leaves in place and compares
the int32 (equal below 2^24 drivables).
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import (
    P_LEN, P_MAXNEGACC, P_MAXSPEED, P_TURNSPEED, P_USUALPOSACC, P_YIELD,
    can_yield, egat, gat, reach_steps)
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_f32 = 0       # float32 (fast-mode) launches among them
I32_MAX = 2 ** 31 - 1
OWN = ("exists", "yield", "cleared", "cyc", "dpos", "dist", "reach", "ent",
       "pri", "idx")
_BOOL = ("exists", "yield", "cleared", "cyc", "dpos")
LEAVES = ("dis", "speed", "params", "cyc", "prev_drv", "enter_ll_time",
          "priority")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "d", "drv_len", "ll_end", "ll_start", "ll_is_turn", "last_of",
        "first_of", "sorted_idx", "drv_off", "veh_next", "ll_avail")
        + LEAVES + ("interval", "exists", "yld", "cleared", "cyc_out",
                    "dpos", "dist", "reach", "ent_out", "pri_out", "idx")]
        + [(n, ctypes.c_int) for n in (
            "B", "LL", "KC", "K", "NP", "V", "L", "D", "fp32")])


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


def notify_cross_plain(net, arr, veh_next, ll_avail, leaves, L, k_link):
    """Plain PyTorch version: the JAX package's K2-round where-chain in
    (..., LL, KC) layout over the candidates [end lane's rear vehicle,
    the lanelink's first k_link vehicles, start lane's front vehicle],
    each candidate's attributes gathered from the leaves (the einsum of a
    one-hot row holds one term: the winner's slot)."""
    from cityflow_tpu_torch.kernels.arrange import link_rows
    d = net["lnk_cross_d"]                               # (LL, KC)
    LL, KC = d.shape
    B = veh_next.shape[0]
    dev = d.device
    dis, p = leaves["dis"], leaves["params"]
    ll_len = net["drv_len"][L:L + LL]
    lv = link_rows(arr, L, LL, k_link)                   # (B, LL, K)
    per_link = lambda t: t.expand(B, LL)
    last_slot = egat(arr["last_of"], per_link(net["ll_end"]))
    first_slot = egat(arr["first_of"], per_link(net["ll_start"]))
    first_next = egat(veh_next, first_slot)
    start_len = gat(net["drv_len"], net["ll_start"])
    # every candidate's slot, (B, LL, K2); -1 rows are never eligible
    v_stack = torch.cat([last_slot[..., None], lv, first_slot[..., None]],
                        2)
    dis_k = egat(dis, v_stack)
    len_k = egat(p[..., P_LEN], v_stack)
    p_stack = torch.cat([(ll_len + dis_k[..., 0])[..., None],
                         dis_k[..., 1:-1],
                         (-(start_len - dis_k[..., -1]))[..., None]], 2)
    l_drv = L + torch.arange(LL, dtype=torch.int32, device=dev)
    e_ok = (last_slot >= 0) & (egat(leaves["prev_drv"], last_slot) == l_drv)
    t_e = ll_len + dis_k[..., 0] - len_k[..., 0]
    tails = dis_k[..., 1:-1] - len_k[..., 1:-1]
    s_ok = (first_slot >= 0) & (first_next == l_drv) & ll_avail

    K2 = k_link + 2
    shape = (B, LL, KC)
    best_p = torch.full(shape, -1e30, dtype=d.dtype, device=dev)
    best_k = torch.zeros(shape, dtype=torch.int64, device=dev)
    best_v = torch.full(shape, -1, dtype=torch.int32, device=dev)
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
    # the winner's slot (candidate 0's, clamped, where none wins)
    ws = torch.gather(v_stack, 2, best_k)
    at = lambda x: egat(x, ws)
    speed, length = at(leaves["speed"]), at(p[..., P_LEN])
    won = best_v >= 0
    ndist = d - best_p
    target = torch.where(net["ll_is_turn"][:, None], at(p[..., P_TURNSPEED]),
                         at(p[..., P_MAXSPEED]))
    return {
        "exists": won,
        "yield": can_yield(speed, at(p[..., P_MAXNEGACC]),
                           at(p[..., P_YIELD]), length, ndist),
        "cleared": ndist + length < 0,
        "cyc": at(leaves["cyc"]),
        "dpos": ndist > 0,
        "dist": ndist,
        "reach": reach_steps(speed, ndist, target, at(p[..., P_USUALPOSACC]),
                             net["interval"]),
        "ent": torch.where(won, at(leaves["enter_ll_time"]), 0),
        "pri": torch.where(won, at(leaves["priority"]), 0), "idx": best_v}


def offsets_fit(B, V, NP, LL, KC, D):
    """The kernel's offsets are 32-bit: B * V * NP (the params leaf), B *
    LL * KC (the outputs) and B * (D + 1) (drv_off) must fit, or this
    raises (the CPU path too, so that the tests see the refusal)."""
    if max(B * V * NP, B * LL * KC, B * (D + 1)) > I32_MAX:
        raise ValueError(f"notify_cross: B={B} V={V} NP={NP} LL={LL} "
                         f"KC={KC} D={D} do not fit the kernel's 32-bit "
                         "offsets")


def notify_cross(net, arr, veh_next, ll_avail, leaves, L, k_link):
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
           net["ll_is_turn"], arr["last_of"], arr["first_of"],
           arr["sorted_idx"], arr["drv_off"], veh_next, ll_avail,
           *(leaves[k] for k in LEAVES), net["interval"])
    _lib.check_args("notify_cross", *ins,
                    dtypes=[f64, f64, i32, i32, b8, i32, i32, i32, i32, i32,
                            b8, f64, f64, f64, b8, i32, i32, i32, f64],
                    cuda=not cpu)
    if len(lead) != 1:
        raise ValueError("notify_cross: veh_next must be (B, V)")
    BV = tuple(veh_next.shape)
    D = arr["last_of"].shape[-1]
    p = leaves["params"]
    if any(tuple(leaves[k].shape) != BV for k in LEAVES if k != "params") \
            or tuple(p.shape[:-1]) != BV \
            or tuple(arr["sorted_idx"].shape) != BV \
            or tuple(arr["drv_off"].shape) != lead + (D + 1,) \
            or tuple(ll_avail.shape) != lead + (LL,):
        raise ValueError("notify_cross: leaves and sorted_idx must be (B, "
                         f"V) (params (B, V, NP)), drv_off (B, D + 1) and "
                         f"ll_avail (B, LL), LL = {LL}, with veh_next's "
                         "shape")
    offsets_fit(lead[0], BV[1], p.shape[-1], LL, KC, D)
    if cpu:
        return notify_cross_plain(net, arr, veh_next, ll_avail, leaves, L,
                                  k_link)
    return _launch(ins, LL, KC, k_link, L, p.shape[-1])


def _launch(ins, LL, KC, K, L, NP):
    global launches, launches_f32
    fp32 = _lib.fp32("notify_cross", *ins)
    d, veh_next = ins[0], ins[9]
    B, V = veh_next.shape
    dev = d.device
    out = {k: torch.empty((B, LL, KC), dtype=torch.bool, device=dev)
           for k in _BOOL}
    out["dist"] = torch.empty((B, LL, KC), dtype=d.dtype, device=dev)
    for k in ("reach", "ent", "pri", "idx"):
        out[k] = torch.empty((B, LL, KC), dtype=torch.int32, device=dev)
    a = _Args(*(t.data_ptr() for t in ins),
              *(out[k].data_ptr() for k in OWN),
              B, LL, KC, K, NP, V, L, ins[5].shape[-1], fp32)
    _lib.check(_lib.lib().notify_cross(ctypes.byref(a), _lib.stream_ptr(d)),
               "notify_cross")
    launches += 1
    launches_f32 += fp32
    return out
