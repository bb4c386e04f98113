"""L2 lc_receive: Vehicle::receiveSignal arbitration, yieldSpeed and the
decision to change (csrc/lc_receive.cu).

Per (slot, lane, env) receiver: of the 2*SL senders on its inner lane
(direction +1) and its outer lane (direction -1) whose target leader or
follower slot is the receiver, keep the one of highest priority (inner
lane first, slots ascending, a tie keeps the first); only the follower role
yields, at noCollisionSpeed(sender speed, maxNegAcc, my speed, maxNegAcc,
sender's yield gap). Outputs yv (float32, 100 = no-op) and do_change
(bool).

The kernel walks each (lane, env) column's neighbour senders once, each
offering itself to its two receivers, and keeps every receiver's best in
shared memory. It takes plan as L1 gives it, set only on occupied rows
(s < n_l): rows at or past n_l are read neither as senders nor as
receivers.

The template mode (JAX ring_lc.py:322-361 under non-uniform templates)
takes the ring's `tpl` channel and the (TP, 12) table: the kept sender's
maxNegAcc and the receiver's come from their templates. Its own kernel
instantiation.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import no_collision_speed
from cityflow_tpu_torch.compiler.net import P_MAXNEGACC
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels._nbr import nbcol, scalar
from cityflow_tpu_torch.kernels.tpl_params import tpl_params_plain

launches = 0
launches_tpl = 0        # of those, in the template mode


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "plan", "dirc", "tl_slot", "ygap", "hsig", "gval", "speed", "pri",
        "n_l", "chg", "inner", "outer", "yv", "do_change")] \
        + [(n, ctypes.c_longlong) for n in ("S", "N", "B")] \
        + [("neg", ctypes.c_float), ("dt", ctypes.c_float)] \
        + [("tpl", ctypes.c_void_p), ("table", ctypes.c_void_p),
           ("TP", ctypes.c_int)]


def lc_receive_plain(plan, dirc, tl_slot, ygap, hsig, gval, speed, pri,
                     n_l, chg, tabs, prm, tpl=None, table=None):
    """Plain PyTorch version of ring_lc.lc_phase's sendSignal /
    receiveSignal and schedule (ring_lc.py:313-367)."""
    neg, dt = prm
    neg_s = None if tpl is None else \
        tpl_params_plain(tpl, table, (P_MAXNEGACC,))[0]
    SL = plan.shape[0]
    dev = plan.device
    my_slot = torch.arange(SL, dtype=torch.int32, device=dev)[:, None, None]
    got = torch.zeros(plan.shape, dtype=torch.bool, device=dev)
    best_pri = torch.zeros(plan.shape, dtype=torch.int32, device=dev)
    role_f = torch.zeros_like(got)
    best_spd = torch.zeros(plan.shape, device=dev)
    best_gap = torch.zeros(plan.shape, device=dev)
    best_sneg = torch.ones(plan.shape, device=dev)
    for src, want in ((tabs["inner_src"], 1), (tabs["outer_src"], -1)):
        s_pl, s_dir, s_tl = nbcol(plan, src), nbcol(dirc, src), \
            nbcol(tl_slot, src)
        s_pri, s_spd, s_gap = nbcol(pri, src), nbcol(speed, src), \
            nbcol(ygap, src)
        s_neg = None if tpl is None else nbcol(neg_s, src)
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
            if tpl is not None:
                best_sneg = torch.where(better, s_neg[t], best_sneg)
            got = got | cand
    occ = my_slot < n_l[None]
    received = occ & ~chg & got & ~(hsig & ~(best_pri > pri))
    if tpl is None:
        f_neg = scalar(neg, speed)
        v_y = no_collision_speed(best_spd, f_neg, speed, f_neg, best_gap,
                                 scalar(dt, speed), scalar(0.0, speed))
    else:
        # noCollisionSpeed(srcSpeed, the source's maxNegAcc, mySpeed, mine)
        v_y = no_collision_speed(best_spd, best_sneg, speed, neg_s, best_gap,
                                 scalar(dt, speed), scalar(0.0, speed))
    v_y = torch.where(v_y < 0, 100.0, v_y)
    yv = torch.where(received & role_f, v_y, 100.0)
    do_change = plan & hsig & ~received & ~chg & gval & (dirc != 0)
    return yv, do_change


def lc_receive(plan, dirc, tl_slot, ygap, hsig, gval, speed, pri, n_l, chg,
               tabs, prm, tpl=None, table=None):
    """L2 on CUDA tensors, the plain version on CPU tensors. Rings
    (SL, LNp, B) from L1 and the state; prm = (maxNegAcc, interval). The
    template mode takes tpl (SL, LNp, B) int32 and the (TP, 12) table; of
    prm only the interval is read."""
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
    if (tpl is None) != (table is None):
        raise ValueError("lc_receive: the template mode takes tpl and table")
    if tpl is not None:
        _lib.check_args("lc_receive", tpl, table, dtypes=[i32, f32],
                        cuda=not cpu)
        if tuple(tpl.shape) != (SL, N, B) or table.dim() != 2 \
                or table.shape[1] != 12:
            raise ValueError("lc_receive: template mode shapes")
    if cpu:
        return lc_receive_plain(plan, dirc, tl_slot, ygap, hsig, gval, speed,
                                pri, n_l, chg, tabs, prm, tpl, table)
    return _launch(ins, prm, tpl, table)


def _launch(ins, prm, tpl, table):
    global launches, launches_tpl
    plan = ins[0]
    SL, N, B = plan.shape
    yv = torch.empty((SL, N, B), dtype=torch.float32, device=plan.device)
    do_change = torch.empty((SL, N, B), dtype=torch.bool, device=plan.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    a = _Args(*(t.data_ptr() for t in ins + (yv, do_change)), SL, N, B,
              float(prm[0]), float(prm[1]), ptr(tpl), ptr(table),
              0 if table is None else table.shape[0])
    rc = _lib.lib().lc_receive(ctypes.byref(a), _lib.stream_ptr(plan))
    _lib.check(rc, "lc_receive")
    launches += 1
    launches_tpl += tpl is not None
    return yv, do_change
