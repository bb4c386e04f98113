"""G4 cross_pass: the cross loop of the gen-1 getAction
(csrc/cross_pass.cu).

Per vehicle (V,): the_ll (i32, the lanelink whose crosses apply, -1 for
none), dls (f64, the distance along it, negative before it), speed (f64),
params (V, 12) f64, enter_ll_time and priority (i32), next_turn and
blk_ok (bool: the next drivable turns; running, intersection-related and
not stopped at a red light). `own` is G3's own-side dict; `net` holds
lnk_cross_d, lnk_cross_valid, lnk_cross_foetype, lnk_cross_foe_pos,
ll_type, ll_is_turn and interval.

Returns v_isr (f64: max speed, capped at the turn speed before a turn and
at the stop speed before the first cross the vehicle must yield at),
any_fail (bool), ff_d (f64: that cross's distance, the first cross's when
none) and new_blocker (i32: that cross's notifier where blk_ok, else -1).
In fast mode every f64 above is float32 (one float dtype per call).
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import (
    P_LEN, P_MAXNEGACC, P_MAXSPEED, P_TURNSPEED, P_USUALNEGACC,
    P_USUALPOSACC, P_YIELD, can_yield, foe_view, gat, reach_steps, ref_min,
    stop_before_speed)
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels.notify_cross import OWN

launches = 0
launches_f32 = 0       # float32 (fast-mode) launches among them
TABLES = ("lnk_cross_d", "lnk_cross_valid", "lnk_cross_foetype",
          "lnk_cross_foe_pos", "ll_type", "ll_is_turn")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "the_ll", "dls", "speed", "params", "ent", "pri", "next_turn",
        "blk_ok", "cd", "cvalid", "foetype", "foe_pos", "ll_type",
        "ll_is_turn", "o_exists", "o_yield", "o_cleared", "o_cyc", "o_dpos",
        "o_dist", "o_reach", "o_ent", "o_pri", "o_idx", "interval", "v_isr",
        "any_fail", "ff_d", "new_blocker")]
        + [(n, ctypes.c_longlong) for n in ("V", "LL", "KC", "NP", "fp32")])


def cross_pass_plain(the_ll, dls, speed, params, ent, pri, next_turn, blk_ok,
                     own, net):
    """Plain PyTorch version: the JAX package's (V, KC) slabs, the foe
    side gathered through lnk_cross_foe_pos."""
    p = params
    dt = net["interval"]
    LL = net["lnk_cross_d"].shape[0]
    foe = {k[4:]: v for k, v in foe_view(net, own).items()}
    v_isr = torch.where(next_turn, torch.minimum(p[:, P_MAXSPEED],
                                                 p[:, P_TURNSPEED]),
                        p[:, P_MAXSPEED])
    has_ll = the_ll >= 0
    safe = the_ll.clamp(0, LL - 1)
    rows = lambda t: t.index_select(0, safe)
    cvalid = rows(net["lnk_cross_valid"]) & has_ll[:, None]
    d_onl = rows(net["lnk_cross_d"])
    t2 = rows(net["lnk_cross_foetype"])
    t1 = gat(net["ll_type"], the_ll)[:, None]
    fr, d2 = rows(foe["reach"]), rows(foe["dist"])
    foe_ent, foe_pri = rows(foe["ent"]), rows(foe["pri"])
    foe_dpos, foe_cleared = rows(foe["dpos"]), rows(foe["cleared"])

    d1 = d_onl - dls[:, None]
    self_yield = can_yield(speed[:, None], p[:, P_MAXNEGACC][:, None],
                           p[:, P_YIELD][:, None], p[:, P_LEN][:, None], d1)
    self_target = torch.where(gat(net["ll_is_turn"], the_ll),
                              p[:, P_TURNSPEED], p[:, P_MAXSPEED])[:, None]
    sr = reach_steps(speed[:, None], d1, self_target,
                     p[:, P_USUALPOSACC][:, None], dt)
    my_ent, my_pri = ent[:, None], pri[:, None]
    one = torch.ones((), dtype=torch.int32, device=dls.device)
    zero = 0 * one
    same_rank_y = torch.where(
        fr > sr, -one, torch.where(
            fr < sr, one, torch.where(
                my_ent == foe_ent,
                torch.where(d1 == d2, torch.where(my_pri > foe_pri, -one, one),
                            torch.where(d1 < d2, -one, one)),
                torch.where(my_ent < foe_ent, -one, one))))
    t_eq = torch.where(foe_dpos, same_rank_y,
                       torch.where(foe_cleared, -one, one))
    t_lt_pre = torch.where(foe_dpos, torch.where(fr > sr, -one, zero),
                           torch.where(foe_cleared, -one, zero))
    t_lt = torch.where(t_lt_pre == 0, one, t_lt_pre)
    y0 = torch.where(t1 > t2, -one, torch.where(t1 < t2, t_lt, t_eq))
    y = torch.where(~rows(foe["yield"]), one, y0)
    y = torch.where((y == 1) & rows(foe["cyc"]), -one, y)
    passes = ~rows(foe["exists"]) | ~self_yield | (y == -1)

    fail = cvalid & (d_onl >= dls[:, None]) & ~passes
    any_fail = torch.any(fail, dim=1)
    first_fail = torch.argmax(fail.to(torch.int32), dim=1, keepdim=True)
    ff_d = torch.gather(d_onl, 1, first_fail)[:, 0]
    ff_foe = torch.gather(rows(foe["idx"]), 1, first_fail)[:, 0]
    v_stop = stop_before_speed(speed, p[:, P_USUALPOSACC],
                               p[:, P_USUALNEGACC],
                               ff_d - dls - p[:, P_YIELD], dt)
    v_isr = torch.where(any_fail, ref_min(v_isr, v_stop), v_isr)
    new_blocker = torch.where(blk_ok & any_fail, ff_foe, -1)
    return v_isr, any_fail, ff_d, new_blocker


def cross_pass(the_ll, dls, speed, params, ent, pri, next_turn, blk_ok, own,
               net):
    """G4 on CUDA tensors, the plain version on CPU tensors."""
    cpu = the_ll.device.type == "cpu"
    i32, f64, b8 = (torch.int32,), _lib.FLOATS, (torch.bool,)
    tabs = [net[k] for k in TABLES]
    owns = [own[k] for k in OWN]
    _lib.check_args("cross_pass", the_ll, dls, speed, params, ent, pri,
                    next_turn, blk_ok, *tabs, *owns, net["interval"],
                    dtypes=[i32, f64, f64, f64, i32, i32, b8, b8,
                            f64, b8, i32, i32, i32, b8,
                            b8, b8, b8, b8, b8, f64, i32, i32, i32, i32,
                            f64], cuda=not cpu)
    V = the_ll.shape[0]
    LL, KC = net["lnk_cross_d"].shape
    for i, t in enumerate((dls, speed, ent, pri, next_turn, blk_ok)):
        if t.shape[0] != V:
            raise ValueError(f"cross_pass: a per-vehicle input has "
                             f"{t.shape[0]} rows, not {V}")
    for k, t in zip(OWN, owns):
        if tuple(t.shape) != (LL, KC):
            raise ValueError(f"cross_pass: own[{k!r}] {tuple(t.shape)} != "
                             f"{(LL, KC)}")
    if cpu:
        return cross_pass_plain(the_ll, dls, speed, params, ent, pri,
                                next_turn, blk_ok, own, net)
    return _launch(the_ll, dls, speed, params, ent, pri, next_turn, blk_ok,
                   tabs, owns, net["interval"], LL, KC)


def _launch(the_ll, dls, speed, params, ent, pri, next_turn, blk_ok, tabs,
            owns, interval, LL, KC):
    global launches, launches_f32
    fp32 = _lib.fp32("cross_pass", dls, speed, params, interval, *owns)
    V = the_ll.shape[0]
    dev = the_ll.device
    v_isr = torch.empty(V, dtype=dls.dtype, device=dev)
    any_fail = torch.empty(V, dtype=torch.bool, device=dev)
    ff_d = torch.empty(V, dtype=dls.dtype, device=dev)
    new_blocker = torch.empty(V, dtype=torch.int32, device=dev)
    a = _Args(*(t.data_ptr() for t in (
        the_ll, dls, speed, params, ent, pri, next_turn, blk_ok, *tabs,
        *owns, interval, v_isr, any_fail, ff_d, new_blocker)),
        V, LL, KC, params.shape[1], fp32)
    _lib.check(_lib.lib().cross_pass(ctypes.byref(a), _lib.stream_ptr(dls)),
               "cross_pass")
    launches += 1
    launches_f32 += fp32
    return v_isr, any_fail, ff_d, new_blocker
