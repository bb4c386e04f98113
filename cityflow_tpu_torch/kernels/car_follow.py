"""K3 car_follow: getIntersectionRelatedSpeed (isr_speed) and
Vehicle::getNextSpeed's min-rule (min_chain), fused (csrc/car_follow.cu).

mode 1 runs isr_speed and returns (v_isr, red_stop); mode 2 runs min_chain
on a given v_isr and returns (new_speed, delta), or v when raw; mode 3 runs
both with the intersection speed kept inside. The lane-change mode is
min_chain with a `v_yield` input (the yieldSpeed term, applied after the
intersection term; JAX ring.py:1081) and, on the lane-change path, raw: its
own kernel instantiation, so the one without v_yield is unchanged.

Inputs are keyword tensors that broadcast to `shape` under PyTorch's rules
with their non-1 dimensions in one contiguous block (a (LPI, G, 1) table
against (SK, LPI, G, B) rows), or Python scalars. Parameters are the
subject's: maxspd, turnspd, upa, una, yld, maxneg, mingap, headway, maxpos,
dt, as Python floats (used as float32, like JAX's f(p) constants).

The template mode (non-uniform vehicle templates; JAX ring.py:1001-1064)
takes `tpl` (the subject's template index) and, with min_chain, `lead_tpl`
(its leader's), int32 tensors of the full `shape`, and the (TP, 12) table
`table`: the subject's parameters come from its template, the leader's
maxNegAcc and usualNegAcc from the leader's (vehicle.cpp:217, 229); of
`prm` only dt is read. Its own instantiation: the uniform one is unchanged.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import no_collision_speed, stop_before_speed
from cityflow_tpu_torch.compiler.net import (
    P_HEADWAY, P_MAXNEGACC, P_MAXPOSACC, P_MAXSPEED, P_MINGAP, P_TURNSPEED,
    P_USUALNEGACC, P_USUALPOSACC, P_YIELD)
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels.tpl_params import tpl_params_plain

launches = 0
launches_lc = 0         # of those, in the lane-change mode (v_yield)
launches_tpl = 0        # of those, in the template mode
launches_tpl_lc = 0     # of those, in the template and lane-change modes

INPUTS = ("speed", "dls", "isr_lane_left", "any_fail", "ff_d", "app", "avail",
          "can_enter", "turn", "gap", "lead_spd", "has_lead", "v_isr",
          "isr_rel", "custom", "has_custom", "drv_maxspd", "invalid",
          "lane_left", "v_yield")
PARAMS = ("maxspd", "turnspd", "upa", "una", "yld", "maxneg", "mingap",
          "headway", "maxpos", "dt")
# the table column of each template parameter (all of PARAMS but dt)
TPL_COLS = (P_MAXSPEED, P_TURNSPEED, P_USUALPOSACC, P_USUALNEGACC, P_YIELD,
            P_MAXNEGACC, P_MINGAP, P_HEADWAY, P_MAXPOSACC)
ISR_INPUTS = ("speed", "dls", "isr_lane_left", "any_fail", "ff_d", "app",
              "avail", "can_enter", "turn")
MC_INPUTS = ("speed", "gap", "lead_spd", "has_lead", "isr_rel", "custom",
             "has_custom", "drv_maxspd", "invalid", "lane_left")


class _View(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("div", ctypes.c_longlong),
                ("mod", ctypes.c_longlong), ("val", ctypes.c_float),
                ("is_bool", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = ([("inp", _View * len(INPUTS)),
                 ("out_v", ctypes.c_void_p), ("out_delta", ctypes.c_void_p),
                 ("out_red", ctypes.c_void_p), ("n", ctypes.c_longlong),
                 ("mode", ctypes.c_int), ("raw", ctypes.c_int)]
                + [(n, ctypes.c_float) for n in PARAMS]
                + [("with_yield", ctypes.c_int), ("tpl", ctypes.c_void_p),
                   ("lead_tpl", ctypes.c_void_p), ("table", ctypes.c_void_p),
                   ("TP", ctypes.c_int)])


def ref_min(a, b):
    """The reference's std::min(a, b), b < a ? b : a: a NaN in b leaves a
    (torch.minimum and the JAX step's jnp.minimum return the NaN). The
    isr_speed mins take the stop-before speed, which is 0 / 0 for a
    stopped vehicle with no distance left (vehicle.cpp getStopBeforeSpeed);
    elsewhere the two agree."""
    return torch.where(b < a, b, a)


def _needed(mode):
    need = set(ISR_INPUTS) if mode & 1 else set()
    if mode & 2:
        need |= set(MC_INPUTS) | (set() if mode & 1 else {"v_isr"})
    return need


def car_follow_plain(mode, prm, shape, raw=False, tpl=None, lead_tpl=None,
                     table=None, **inp):
    """Plain PyTorch version: isr_speed / min_chain of the JAX ring step."""
    dev = inp["speed"].device
    p = {k: torch.tensor(float(v), dtype=torch.float32, device=dev)
         for k, v in zip(PARAMS, prm)}
    l_maxneg, l_una = p["maxneg"], p["una"]
    if tpl is not None:
        p.update(zip(PARAMS, tpl_params_plain(tpl, table, TPL_COLS)))
        if mode & 2:
            l_maxneg, l_una = tpl_params_plain(
                lead_tpl, table, (P_MAXNEGACC, P_USUALNEGACC))
        else:
            l_maxneg, l_una = p["maxneg"], p["una"]
    g = {k: (v if torch.is_tensor(v) else torch.tensor(v, device=dev))
         for k, v in inp.items()}
    speed = g["speed"]
    dt = p["dt"]
    if mode & 1:
        v_isr = torch.full(shape, float(prm[0]), device=dev) if tpl is None \
            else torch.broadcast_to(p["maxspd"], shape)
        app = g["app"]
        v_isr = torch.where(app & g["turn"],
                            torch.minimum(v_isr, p["turnspd"]), v_isr)
        v_stop = stop_before_speed(speed, p["upa"], p["una"],
                                   g["ff_d"] - g["dls"] - p["yld"], dt)
        v_isr = torch.where(g["any_fail"], ref_min(v_isr, v_stop), v_isr)
        red = app & (~g["avail"] | ~g["can_enter"])
        min_brake = 0.5 * speed * speed / p["maxneg"]
        red_stop = red & ~(min_brake > g["isr_lane_left"])
        v_red = ref_min(p["maxspd"], stop_before_speed(
            speed, p["upa"], p["una"], g["isr_lane_left"], dt))
        v_isr = torch.where(red_stop, v_red, v_isr)
        if not mode & 2:
            return v_isr, torch.broadcast_to(red_stop, shape)
    else:
        v_isr = g["v_isr"]
    lead_spd, gap = g["lead_spd"], g["gap"]
    custom, has_custom = g["custom"], g["has_custom"]
    v_hard = no_collision_speed(lead_spd, l_maxneg, speed, p["maxneg"],
                                gap, dt, torch.zeros((), device=dev))
    assume_decel = torch.where(speed > lead_spd, speed - lead_spd, 0.0)
    v_soft = no_collision_speed(lead_spd, l_una, speed, p["una"], gap, dt,
                                p["mingap"])
    v_headway = ((gap + (lead_spd + assume_decel / 2) * dt - speed * dt / 2)
                 / (p["headway"] + dt / 2))
    v_plain = torch.minimum(torch.minimum(v_hard, v_soft), v_headway)
    v_cust = torch.minimum(custom, v_hard)
    v_lead = torch.where(has_custom, v_cust, v_plain)
    v_nolead = torch.where(has_custom, custom, p["maxspd"])
    v_cf = torch.where(g["has_lead"], v_lead, v_nolead)
    v = torch.minimum(p["maxspd"], speed + p["maxpos"] * dt)
    v = torch.minimum(v, g["drv_maxspd"])
    v = torch.minimum(v, v_cf)
    v = torch.where(g["isr_rel"], torch.minimum(v, v_isr), v)
    if "v_yield" in g:
        v = torch.minimum(v, g["v_yield"])
    v_inv = no_collision_speed(torch.zeros((), device=dev),
                               torch.ones((), device=dev), speed,
                               p["maxneg"], g["lane_left"], dt, p["mingap"])
    v = torch.where(g["invalid"], torch.minimum(v, v_inv), v)
    v = torch.maximum(v, speed - p["maxneg"] * dt)
    v = torch.broadcast_to(v, shape)
    if raw:
        return v
    neg = v < 0
    delta = torch.where(neg, 0.5 * speed * speed / p["maxneg"],
                        (speed + v) * dt / 2)
    return torch.where(neg, 0.0, v), torch.broadcast_to(delta, shape)


def _view(x, shape, name):
    if not torch.is_tensor(x):
        return _View(None, 1, 1, float(x), 0)
    nd = len(shape)
    if x.dim() > nd:
        raise ValueError(f"car_follow: {name} has more dims than the rows")
    xs = (1,) * (nd - x.dim()) + tuple(x.shape)
    big = [d for d in range(nd) if xs[d] != 1]
    if big:
        lo, hi = big[0], big[-1]
        if any(xs[d] != shape[d] for d in range(lo, hi + 1)):
            raise ValueError(f"car_follow: {name} {tuple(x.shape)} is not a "
                             f"contiguous block of {tuple(shape)}")
        div = 1
        for d in shape[hi + 1:]:
            div *= d
    else:
        div = 1
    if x.dtype not in (torch.float32, torch.bool):
        raise ValueError(f"car_follow: {name} has dtype {x.dtype}")
    return _View(x.data_ptr(), div, max(x.numel(), 1), 0.0,
                 int(x.dtype == torch.bool))


def _check_tpl(mode, shape, tpl, lead_tpl, table):
    if tpl is None:
        if lead_tpl is not None or table is not None:
            raise ValueError("car_follow: lead_tpl / table without tpl")
        return []
    need = [tpl] + ([lead_tpl] if mode & 2 else [])
    if table is None or any(t is None for t in need):
        raise ValueError("car_follow: the template mode needs table and, "
                         "with min_chain, lead_tpl")
    for t in need:
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"car_follow: template index {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} int32")
    if table.dim() != 2 or table.shape[1] != 12 \
            or table.dtype != torch.float32:
        raise ValueError(f"car_follow: table {tuple(table.shape)}")
    return need + [table]


def car_follow(mode, prm, shape, raw=False, tpl=None, lead_tpl=None,
               table=None, **inp):
    """K3 on CUDA tensors, the plain version on CPU tensors."""
    global launches, launches_lc, launches_tpl, launches_tpl_lc
    missing = _needed(mode) - set(inp)
    if "v_yield" in inp and mode != 2:
        raise ValueError("car_follow: v_yield goes with mode 2")
    if missing:
        raise ValueError(f"car_follow: missing inputs {sorted(missing)}")
    shape = tuple(shape)
    cpu = inp["speed"].device.type == "cpu"
    tens = [v for v in inp.values() if torch.is_tensor(v)]
    tens += _check_tpl(mode, shape, tpl, lead_tpl, table)
    _lib.check_args("car_follow", *tens, cuda=not cpu)
    views = [_view(inp[k], shape, k) if k in inp else _View(None, 1, 1, 0.0, 0)
             for k in INPUTS]
    if cpu:
        return car_follow_plain(mode, prm, shape, raw, tpl, lead_tpl, table,
                                **inp)
    dev = inp["speed"].device
    n = 1
    for d in shape:
        n *= d
    out_v = torch.empty(shape, dtype=torch.float32, device=dev)
    out_d = out_r = None
    if mode == 1:
        out_r = torch.empty(shape, dtype=torch.bool, device=dev)
    elif not raw:
        out_d = torch.empty(shape, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    a = _Args((_View * len(INPUTS))(*views), out_v.data_ptr(), ptr(out_d),
              ptr(out_r), n, mode, int(raw),
              *(float(prm[i]) for i in range(len(PARAMS))),
              int("v_yield" in inp), ptr(tpl),
              ptr(lead_tpl if mode & 2 else None), ptr(table),
              0 if table is None else table.shape[0])
    rc = _lib.lib().car_follow(ctypes.byref(a), _lib.stream_ptr(out_v))
    _lib.check(rc, "car_follow")
    launches += 1
    launches_lc += "v_yield" in inp
    launches_tpl += tpl is not None
    launches_tpl_lc += tpl is not None and "v_yield" in inp
    if mode == 1:
        return out_v, out_r
    return out_v if raw else (out_v, out_d)
