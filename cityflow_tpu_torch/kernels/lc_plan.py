"""G7 lc_plan: planLaneChange of the gen-1 step (csrc/lc_plan.cu), in
four modes:

  signal   makeSignal, the target lane, its leader and follower and the
           two gaps: dict(has_signal, target, direction, plan, tleader,
           tfollower, lgap, fgap), given G6's neighbours `nb` and G1's
           last_of
  receive  the two scatter-max passes of the signal arbitration:
           dict(best_l, best_f, slot_l, slot_f), the highest sender
           priority per receiver (-2^31: none) and the largest sender
           slot of that priority (-1), target leaders and followers apart
  decide   dict(lc_recv, do_change): the signal a slot keeps and whether
           it starts a change (gap validity)
  yield    yieldSpeed of each signal receiver, 100 for the others (f64)

`st` is the gen-1 SimState of B envs ((B, V) leaves, params (B, V, 12),
step (B,); float64, or float32 in fast mode; one env is B = 1), `net`
the step's device tables, shared by the envs; every output is (B, V) and
covers every slot, as the JAX package's vmapped (V,) slabs do. Slot
indices (leaders, followers, senders) are local to their env.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import (
    P_LEN, P_MAXNEGACC, P_MAXSPEED, chain_step, egat, gat,
    no_collision_speed, on_last_road)
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_signal = launches_receive = launches_decide = launches_yield = 0
launches_f32 = 0       # float32 (fast-mode) launches, every mode
MODES = ("signal", "receive", "decide", "yield")
COOLING_TIME = 3.0          # lanechange.h:43
INT_MIN = -2**31
SLOTS = ("running", "is_shadow", "lc_changing", "lc_last_t", "drv", "dis",
         "speed", "gap", "params", "route", "route_pos", "lc_target",
         "priority", "step")
NB = ("outer_lane", "inner_lane", "outer_leader", "outer_follower",
      "inner_leader", "inner_follower")
TABLES = ("drv_len", "lane_out", "lane_local", "ll_end", "route_len",
          "route_next_ll")
SIG = ("has_signal", "target", "direction", "plan", "tleader", "tfollower",
       "lgap", "fgap")
RCV = ("best_l", "best_f", "slot_l", "slot_f")
DEC = ("lc_recv", "do_change")
YIELD_IN = ("lc_recv", "lc_fgap", "lc_tleader", "lc_tfollower")
BOOLS = frozenset({"running", "is_shadow", "lc_changing", "has_signal",
                   "plan", "do_change"})
F64 = frozenset({"lc_last_t", "dis", "speed", "gap", "params", "lc_fgap",
                 "lgap", "fgap", "drv_len", "interval"})


def _dtype(name):
    """The dtype the kernel reads an argument as, by name."""
    if name in BOOLS:
        return (torch.bool,)
    return _lib.FLOATS if name in F64 else (torch.int32,)


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        SLOTS + NB + TABLES + ("last_of", "interval") + SIG + RCV + DEC
        + tuple("y_" + k[3:] for k in YIELD_IN) + ("yield_v",))]
        + [(n, ctypes.c_longlong) for n in (
            "B", "V", "L", "D", "KO", "NR", "RLEN", "MAXLPR", "NP",
            "fp32")])


def _signal_plain(st, net, L, nb, last_of):
    """plan_lane_change up to the gaps (JAX lanechange.py:116-189)."""
    p = st.params
    dt = net["interval"]
    inf = torch.tensor(torch.inf, dtype=st.dis.dtype, device=st.dis.device)
    now = (st.step.to(st.dis.dtype) * dt)[:, None]
    on_lane = st.running & (st.drv >= 0) & (st.drv < L)
    real = ~st.is_shadow
    past_cool = now - st.lc_last_t >= COOLING_TIME
    mk = st.running & real & ~st.lc_changing & past_cool
    lane_left = gat(net["drv_len"], st.drv) - st.dis
    gap_ok = on_lane & (lane_left >= 30)
    cur_est = st.gap
    length = p[..., P_LEN]
    expected = 2 * length + 4 * dt * p[..., P_MAXSPEED]
    want = mk & gap_ok & ~(cur_est > expected) & ~(cur_est < 1.5 * length)
    veh = torch.stack([st.dis, length], dim=-1)

    def reachable(lane):
        nxt, _ = chain_step(net, L, st.route, st.route_pos,
                            torch.where(lane < L, lane, -1))
        return on_last_road(net, None, st.route, st.route_pos) | (nxt >= 0)

    def estimate_gap(leader, lane):
        la = egat(veh, leader)
        return torch.where(leader < 0, gat(net["drv_len"], lane) - st.dis,
                           la[..., 0] - st.dis - la[..., 1])

    outer_ok = want & (nb["outer_lane"] < L) & reachable(nb["outer_lane"])
    outer_est = torch.where(outer_ok, estimate_gap(nb["outer_leader"],
                                                   nb["outer_lane"]), 0.0)
    target = torch.where(outer_ok & (outer_est > cur_est + length),
                         nb["outer_lane"], -1)
    inner_ok = want & (nb["inner_lane"] < L) & reachable(nb["inner_lane"])
    inner_est = estimate_gap(nb["inner_leader"], nb["inner_lane"])
    take_inner = inner_ok & (inner_est > cur_est + length) \
        & (inner_est > outer_est)
    target = torch.where(take_inner, nb["inner_lane"], target)
    target = torch.where(st.lc_changing, st.lc_target, target)
    has_signal = mk | st.lc_changing
    direction = torch.where(target < 0, 0, torch.where(
        target == st.drv + 1, 1, torch.where(target == st.drv - 1, -1, 0))
    ).to(torch.int32)
    plan = ((has_signal & (target >= 0) & (target != st.drv))
            | st.lc_changing) & st.running & real

    is_outer = target == nb["outer_lane"]
    tleader = torch.where(is_outer, nb["outer_leader"], nb["inner_leader"])
    tfollower = torch.where(is_outer, nb["outer_follower"],
                            nb["inner_follower"])
    tl = egat(veh, tleader)
    lgap = torch.where(tleader >= 0, tl[..., 0] - st.dis - tl[..., 1], inf)
    rest = lane_left
    no_tl = tleader < 0
    lgap = torch.where(no_tl, rest, lgap)
    best = torch.full_like(st.dis, torch.inf)
    outs = gat(net["lane_out"], target.clamp(0, L - 1))
    for k in range(net["lane_out"].shape[1]):
        ol = outs[..., k]
        cand = torch.where(ol >= 0, egat(last_of, ol), -1)
        ca = egat(veh, cand)
        cgap = ca[..., 0] + rest
        better = no_tl & (cand >= 0) & (cgap < best)
        hit = better & (cgap < ca[..., 1])
        tleader = torch.where(hit, cand, tleader)
        lgap = torch.where(hit, rest - (ca[..., 1] - cgap), lgap)
        best = torch.where(better, cgap, best)
    fgap = torch.where(tfollower >= 0,
                       st.dis - egat(st.dis, tfollower) - length, inf)
    return dict(has_signal=has_signal, target=target, direction=direction,
                plan=plan, tleader=tleader, tfollower=tfollower, lgap=lgap,
                fgap=fgap)


def _receive_plain(st, sig):
    """recv_for of the JAX package (lanechange.py:194-204), per role, each
    env's scatter-max within its own row."""
    B, V = st.dis.shape
    dev = st.dis.device
    sender_ok = sig["plan"] & sig["has_signal"]
    me = torch.arange(V, dtype=torch.int32, device=dev).expand(B, V)
    out = {}
    for tag, role in (("l", sig["tleader"]), ("f", sig["tfollower"])):
        pri = torch.where(sender_ok, st.priority, INT_MIN)
        tgt = torch.where(sender_ok & (role >= 0), role, V).long()
        best = torch.full((B, V + 1), INT_MIN, dtype=torch.int32,
                          device=dev).scatter_reduce(
            -1, tgt, pri, "amax")[:, :V].contiguous()
        key = torch.where(sender_ok & (egat(best, role) == st.priority)
                          & (role >= 0), role, V).long()
        slot = torch.full((B, V + 1), -1, dtype=torch.int32,
                          device=dev).scatter_reduce(
            -1, key, me, "amax")[:, :V].contiguous()
        out["best_" + tag], out["slot_" + tag] = best, slot
    return out


def _decide_plain(st, L, sig, rcv):
    """lc_recv, gap validity and do_change (lanechange.py:208-226)."""
    p = st.params
    bl, bf = rcv["best_l"], rcv["best_f"]
    best_pri = torch.maximum(bl, bf)
    src = torch.where(bl >= bf, rcv["slot_l"], rcv["slot_f"])
    has = sig["has_signal"]
    can_recv = (st.running & ~st.lc_changing
                & ~(has & (st.priority >= best_pri)) & (best_pri > INT_MIN))
    lc_recv = torch.where(can_recv, src, -1)
    min_brake = 0.5 * st.speed * st.speed / p[..., P_MAXNEGACC]
    tf = sig["tfollower"]
    tfb = egat(torch.stack([st.speed, p[..., P_MAXNEGACC]], dim=-1), tf)
    safe_before = torch.where(tf >= 0, 0.5 * tfb[..., 0] * tfb[..., 0]
                              / tfb[..., 1], 0.0)
    gap_valid = (sig["lgap"] >= min_brake) & (sig["fgap"] >= safe_before)
    on_lane = st.running & (st.drv >= 0) & (st.drv < L)
    do_change = (sig["plan"] & has & (lc_recv < 0) & ~st.lc_changing
                 & gap_valid & on_lane & (sig["target"] >= 0))
    return dict(lc_recv=lc_recv, do_change=do_change)


def _yield_plain(st, net):
    """yield_speed of the JAX package (lanechange.py:294-318)."""
    p = st.params
    f = st.dis.dtype
    src = st.lc_recv
    spk = egat(torch.stack([st.speed, p[..., P_MAXNEGACC], st.lc_fgap,
                            st.lc_tleader.to(f)], dim=-1), src)
    src_tf = egat(st.lc_tfollower, src)
    tfb = egat(torch.stack([st.speed, p[..., P_MAXNEGACC]], dim=-1), src_tf)
    safe = torch.where(src_tf >= 0,
                       0.5 * tfb[..., 0] * tfb[..., 0] / tfb[..., 1], 0.0)
    me = torch.arange(st.dis.shape[-1], dtype=torch.int32,
                      device=st.dis.device)
    i_am_leader = spk[..., 3].to(torch.int32) == me
    zero = torch.zeros((), dtype=f, device=st.dis.device)
    v = no_collision_speed(spk[..., 0], spk[..., 1], st.speed,
                           p[..., P_MAXNEGACC], spk[..., 2] - safe,
                           net["interval"], zero)
    v = torch.where(v < 0, 100.0, v)
    return torch.where((src >= 0) & ~i_am_leader, v, 100.0)


def lc_plan_plain(mode, st, net, L, nb=None, last_of=None, sig=None,
                  rcv=None):
    """Plain PyTorch version: the JAX package's formulas over (B, V), each
    gather through a slot index within its env (egat)."""
    if mode == "signal":
        return _signal_plain(st, net, L, nb, last_of)
    if mode == "receive":
        return _receive_plain(st, sig)
    if mode == "decide":
        return _decide_plain(st, L, sig, rcv)
    if mode == "yield":
        return _yield_plain(st, net)
    raise ValueError(f"lc_plan: unknown mode {mode!r}")


def _need(mode):
    """The argument groups a mode reads (the kernel gets null pointers
    for the others)."""
    return {"signal": ("nb", "last_of"), "receive": ("sig",),
            "decide": ("sig", "rcv"), "yield": ()}[mode]


def lc_plan(mode, st, net, L, nb=None, last_of=None, sig=None, rcv=None):
    """G7 on CUDA tensors, the plain version on CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"lc_plan: unknown mode {mode!r}")
    cpu = st.dis.device.type == "cpu"
    given = dict(nb=nb, last_of=last_of, sig=sig, rcv=rcv)
    for g in _need(mode):
        if given[g] is None:
            raise ValueError(f"lc_plan: mode {mode} needs {g}")
    named = [(k, getattr(st, k)) for k in SLOTS] \
        + [(k, net[k]) for k in TABLES + ("interval",)]
    if mode == "yield":
        named += [(k, getattr(st, k)) for k in YIELD_IN]
    if nb is not None:
        named += [(k, nb[k]) for k in NB]
    if last_of is not None:
        named.append(("last_of", last_of))
    for group, keys in (("sig", SIG), ("rcv", RCV)):
        if given[group] is not None:
            named += [(k, given[group][k]) for k in keys]
    _lib.check_args("lc_plan", *(t for _, t in named),
                    dtypes=[_dtype(k) for k, _ in named], cuda=not cpu)
    BV = tuple(st.dis.shape)
    per_slot = [getattr(st, k) for k in SLOTS if k != "step"] + [
        d[k] for d, keys in ((nb, NB), (sig, SIG), (rcv, RCV))
        if d is not None for k in keys]
    if len(BV) != 2 or any(tuple(t.shape[:2]) != BV for t in per_slot) \
            or tuple(st.step.shape) != BV[:1] \
            or (last_of is not None and (last_of.dim() != 2
                                         or last_of.shape[0] != BV[0])):
        raise ValueError("lc_plan: every per-slot input must be (B, V), "
                         "step (B,) and last_of (B, D)")
    if cpu:
        return lc_plan_plain(mode, st, net, L, nb, last_of, sig, rcv)
    return _launch(mode, st, net, L, nb, last_of, sig, rcv)


def _launch(mode, st, net, L, nb, last_of, sig, rcv):
    global launches, launches_signal, launches_receive, launches_decide, \
        launches_yield, launches_f32
    B, V = st.dis.shape
    dev = st.dis.device
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    f64 = dict(dtype=st.dis.dtype, device=dev)
    fp32 = int(st.dis.dtype == torch.float32)
    out = {}
    if mode == "signal":
        out = {k: torch.empty(
            (B, V), **(b8 if k in BOOLS else f64 if k in F64 else i32))
            for k in SIG}
        sig = out
    elif mode == "receive":
        out = {k: torch.full((B, V), INT_MIN if k.startswith("best")
                             else -1, **i32) for k in RCV}
        rcv = out
    elif mode == "decide":
        out = dict(lc_recv=torch.empty((B, V), **i32),
                   do_change=torch.empty((B, V), **b8))
    else:
        out = torch.empty((B, V), **f64)
    ptr = lambda d, k: None if d is None else d[k].data_ptr()
    dec = out if mode == "decide" else None
    ys = [getattr(st, k).data_ptr() if mode == "yield" else None
          for k in YIELD_IN]
    rnl = net["route_next_ll"]
    a = _Args(*([getattr(st, k).data_ptr() for k in SLOTS]
                + [ptr(nb, k) for k in NB]
                + [net[k].data_ptr() for k in TABLES]
                + [None if last_of is None else last_of.data_ptr(),
                   net["interval"].data_ptr()]
                + [ptr(sig, k) for k in SIG] + [ptr(rcv, k) for k in RCV]
                + [ptr(dec, k) for k in DEC] + ys
                + [out.data_ptr() if mode == "yield" else None]),
              B, V, L, net["drv_len"].shape[0], net["lane_out"].shape[1],
              *rnl.shape, st.params.shape[-1], fp32)
    _lib.check(_lib.lib().lc_plan(ctypes.byref(a), MODES.index(mode),
                                  _lib.stream_ptr(st.dis)), "lc_plan")
    launches += 1
    launches_f32 += fp32
    if mode == "signal":
        launches_signal += 1
    elif mode == "receive":
        launches_receive += 1
    elif mode == "decide":
        launches_decide += 1
    else:
        launches_yield += 1
    return out
