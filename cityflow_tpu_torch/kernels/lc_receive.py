"""L2 lc_receive: Vehicle::receiveSignal arbitration, yieldSpeed and the
decision to change (csrc/lc_receive.cu).

Per (slot, lane, env) receiver: of the 2*SL senders on its inner lane
(direction +1) and its outer lane (direction -1) whose target leader or
follower slot is the receiver, keep the one of highest priority (inner
lane first, slots ascending, a tie keeps the first); only the follower role
yields, at noCollisionSpeed(sender speed, maxNegAcc, my speed, maxNegAcc,
sender's yield gap). Outputs yv (float32, 100 = no-op) and do_change
(bool).
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import no_collision_speed
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels._nbr import nbcol, scalar

launches = 0


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "plan", "dirc", "tl_slot", "ygap", "hsig", "gval", "speed", "pri",
        "n_l", "chg", "inner", "outer", "yv", "do_change")] \
        + [(n, ctypes.c_longlong) for n in ("S", "N", "B")] \
        + [("neg", ctypes.c_float), ("dt", ctypes.c_float)]


def lc_receive_plain(plan, dirc, tl_slot, ygap, hsig, gval, speed, pri,
                     n_l, chg, tabs, prm):
    """Plain PyTorch version of ring_lc.lc_phase's sendSignal /
    receiveSignal and schedule (ring_lc.py:313-367)."""
    neg, dt = prm
    SL = plan.shape[0]
    dev = plan.device
    my_slot = torch.arange(SL, dtype=torch.int32, device=dev)[:, None, None]
    got = torch.zeros(plan.shape, dtype=torch.bool, device=dev)
    best_pri = torch.zeros(plan.shape, dtype=torch.int32, device=dev)
    role_f = torch.zeros_like(got)
    best_spd = torch.zeros(plan.shape, device=dev)
    best_gap = torch.zeros(plan.shape, device=dev)
    for src, want in ((tabs["inner_src"], 1), (tabs["outer_src"], -1)):
        s_pl, s_dir, s_tl = nbcol(plan, src), nbcol(dirc, src), \
            nbcol(tl_slot, src)
        s_pri, s_spd, s_gap = nbcol(pri, src), nbcol(speed, src), \
            nbcol(ygap, src)
        for t in range(SL):
            s_ok = s_pl[t] & (s_dir[t] == want)
            as_l = s_tl[t] == my_slot
            as_f = (s_tl[t] + 1) == my_slot
            cand = s_ok & (as_l | as_f)
            better = cand & (~got | (s_pri[t] > best_pri))
            best_pri = torch.where(better, s_pri[t], best_pri)
            role_f = torch.where(better, as_f & ~as_l, role_f)
            best_spd = torch.where(better, s_spd[t], best_spd)
            best_gap = torch.where(better, s_gap[t], best_gap)
            got = got | cand
    occ = my_slot < n_l[None]
    received = occ & ~chg & got & ~(hsig & ~(best_pri > pri))
    f_neg = scalar(neg, speed)
    v_y = no_collision_speed(best_spd, f_neg, speed, f_neg, best_gap,
                             scalar(dt, speed), scalar(0.0, speed))
    v_y = torch.where(v_y < 0, 100.0, v_y)
    yv = torch.where(received & role_f, v_y, 100.0)
    do_change = plan & hsig & ~received & ~chg & gval & (dirc != 0)
    return yv, do_change


def lc_receive(plan, dirc, tl_slot, ygap, hsig, gval, speed, pri, n_l, chg,
               tabs, prm):
    """L2 on CUDA tensors, the plain version on CPU tensors. Rings
    (SL, LNp, B) from L1 and the state; prm = (maxNegAcc, interval)."""
    global launches
    SL, N, B = plan.shape
    f32, i32, b8 = (torch.float32,), (torch.int32,), (torch.bool,)
    ins = (plan, dirc, tl_slot, ygap, hsig, gval, speed, pri, n_l, chg,
           tabs["inner_src"], tabs["outer_src"])
    cpu = plan.device.type == "cpu"
    _lib.check_args("lc_receive", *ins,
                    dtypes=[b8, i32, i32, f32, b8, b8, f32, i32, i32, b8,
                            i32, i32], cuda=not cpu)
    for t in ins[:10]:
        if tuple(t.shape) != ((N, B) if t is n_l else (SL, N, B)):
            raise ValueError(f"lc_receive: shape {tuple(t.shape)}")
    if cpu:
        return lc_receive_plain(plan, dirc, tl_slot, ygap, hsig, gval, speed,
                                pri, n_l, chg, tabs, prm)
    yv = torch.empty((SL, N, B), dtype=torch.float32, device=plan.device)
    do_change = torch.empty((SL, N, B), dtype=torch.bool, device=plan.device)
    a = _Args(*(t.data_ptr() for t in ins + (yv, do_change)), SL, N, B,
              float(prm[0]), float(prm[1]))
    rc = _lib.lib().lc_receive(ctypes.byref(a), _lib.stream_ptr(plan))
    _lib.check(rc, "lc_receive")
    launches += 1
    return yv, do_change
