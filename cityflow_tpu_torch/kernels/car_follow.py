"""K3 car_follow: getIntersectionRelatedSpeed (isr_speed) and
Vehicle::getNextSpeed's min-rule (min_chain), fused (csrc/car_follow.cu).

mode 1 runs isr_speed and returns (v_isr, red_stop); mode 2 runs min_chain
on a given v_isr and returns (new_speed, delta), or v when raw; mode 3 runs
both with the intersection speed kept inside. The lane-change mode is
min_chain with a `v_yield` input (the yieldSpeed term, applied after the
intersection term; JAX ring.py:1081) and, on the lane-change path, raw: its
own kernel instantiation, so the one without v_yield is unchanged.

Inputs are keyword tensors that broadcast to `shape` (at most 4 dims, the
envs last) under PyTorch's rules (a (LPI, G, 1) table against (SK, LPI, G,
B) rows), or Python scalars; the kernel reads each through its strides
over the call's dimensions, 0 where it broadcasts. Parameters are the
subject's: maxspd, turnspd, upa, una, yld, maxneg, mingap, headway, maxpos,
dt, as Python floats (used as float32, like JAX's f(p) constants).

The template mode (non-uniform vehicle templates; JAX ring.py:1001-1064)
takes `tpl` (the subject's template index) and, with min_chain, `lead_tpl`
(its leader's), int32 tensors of the full `shape`, and the (TP, 12) table
`table`: the subject's parameters come from its template, the leader's
maxNegAcc and usualNegAcc from the leader's (vehicle.cpp:217, 229); of
`prm` only dt is read. Its own instantiation: the uniform one is unchanged.

The ring-leader mode (`ring`, a RingLeaders; min_chain only) reads each
element's leader from the ring itself instead of shifted copies of it:
slot s's leader is slot s - 1 (none at slot 0, where a link row's leader
is the end-lane tail of the bundle `s0`), the gap (lead_dis - lead_len) -
dis, and on lane rows lane_left and invalid from the ring's nxt / last
and the lane length; the lane rows' front slots take the approach rows'
results (ap_v, ap_d) where ap_rel holds, through in_inv. So the inputs
gap, lead_spd, has_lead, lead_tpl (and, on lane rows, lane_left and
invalid) are not given. Not raw, it returns (v, delta, new distance):
delta is K3's own (before the approach override), the new distance is
dis + delta or the approach's. Counted apart as car_follow@ring.
"""

import ctypes
from dataclasses import dataclass
from typing import Any

import torch

from cityflow_tpu_torch.core.step import (
    no_collision_speed, ref_min, stop_before_speed)
from cityflow_tpu_torch.compiler.net import (
    P_HEADWAY, P_MAXNEGACC, P_MAXPOSACC, P_MAXSPEED, P_MINGAP, P_TURNSPEED,
    P_USUALNEGACC, P_USUALPOSACC, P_YIELD)
from cityflow_tpu_torch.core.numerics import shift_in, xla_f32_to_i32
from cityflow_tpu_torch.compiler.net import P_LEN
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels.gather_rows import gather_rows_plain
from cityflow_tpu_torch.kernels.tpl_params import tpl_params_plain

launches = 0
launches_lc = 0         # of those, in the lane-change mode (v_yield)
launches_tpl = 0        # of those, in the template mode
launches_tpl_lc = 0     # of those, in the template and lane-change modes
launches_ring = 0       # of those, in the ring-leader mode
launches_ring_link = 0  # of those, on link rows

# the end-lane bundle's channels a link row's slot 0 reads (ring.py's `et`:
# dis, prev, speed, pri hi, pri lo, exists [, tpl])
S0_DIS, S0_SPD, S0_EX, S0_TPL = 0, 2, 5, 6


@dataclass
class RingLeaders:
    """The ring K3's ring-leader mode reads its leaders from. kind "lane"
    or "link"; dis / speed (S, N, B) float32, n (N, B) int32, tpl (S, N,
    B) int32 or None, len_row (N,) the lane / link length, lead_len the
    uniform vehicle length. Lane rows: nxt, last (S, N, B), in_inv (N,),
    the approach rows' ap_v, ap_d (None when raw) and ap_rel, (AP, IL, G,
    B). Link rows: s0, the end-lane bundle (CE, N, B)."""
    kind: str
    dis: Any
    speed: Any
    n: Any
    tpl: Any
    len_row: Any
    lead_len: float
    nxt: Any = None
    last: Any = None
    in_inv: Any = None
    ap_v: Any = None
    ap_d: Any = None
    ap_rel: Any = None
    s0: Any = None

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
    _fields_ = [("p", ctypes.c_void_p), ("st", ctypes.c_int * 4),
                ("val", ctypes.c_float), ("is_bool", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = ([("inp", _View * len(INPUTS)),
                 ("out_v", ctypes.c_void_p), ("out_delta", ctypes.c_void_p),
                 ("out_red", ctypes.c_void_p), ("d", ctypes.c_int * 4),
                 ("mode", ctypes.c_int), ("raw", ctypes.c_int)]
                + [(n, ctypes.c_float) for n in PARAMS]
                + [("with_yield", ctypes.c_int), ("tpl", ctypes.c_void_p),
                   ("lead_tpl", ctypes.c_void_p), ("table", ctypes.c_void_p),
                   ("TP", ctypes.c_int), ("ring", ctypes.c_int)]
                + [(n, ctypes.c_void_p) for n in (
                    "r_dis", "r_spd", "r_tpl", "r_n", "len_row")]
                + [("lead_len", ctypes.c_float)]
                + [(n, ctypes.c_void_p) for n in (
                    "out_dis", "r_nxt", "r_last", "in_inv", "ap_v", "ap_d",
                    "ap_rel")]
                + [(n, ctypes.c_int) for n in ("AP", "ILG")]
                + [("s0", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in (
                    "s0_dis", "s0_spd", "s0_ex", "s0_tpl", "spd_ring",
                    "dls_ring")]
                + [("U", ctypes.c_float * 16), ("hb", ctypes.c_float),
                   ("hbb", ctypes.c_float)])

# the min_chain inputs the ring-leader mode reads from the ring itself
RING_VIEWS = {"lane": ("gap", "lead_spd", "has_lead", "lane_left",
                       "invalid"),
              "link": ("gap", "lead_spd", "has_lead")}


def _needed(mode, ring=None):
    need = set(ISR_INPUTS) if mode & 1 else set()
    if mode & 2:
        need |= set(MC_INPUTS) | (set() if mode & 1 else {"v_isr"})
    if ring is not None:
        need -= set(RING_VIEWS[ring.kind])
    return need


def ring_views(ring, table=None):
    """The leader views the ring-leader mode reads in place, built as the
    ring step built them inline (shifted copies of the ring, JAX
    ring.py:1094-1150, :1301-1386): dict(gap, lead_spd, has_lead
    [, lead_tpl] [, lane_left, invalid]), (S, N, B) each."""
    S, N, B = ring.dis.shape
    dev = ring.dis.device
    occ = torch.arange(S, device=dev)[:, None, None] < ring.n[None]
    lead_dis = shift_in(torch.full((1, N, B), 1e9, device=dev), ring.dis)
    lead_spd = shift_in(torch.zeros((1, N, B), device=dev), ring.speed)
    has_lead = shift_in(torch.zeros((1, N, B), dtype=torch.bool,
                                    device=dev), occ)
    lead_tpl = None if ring.tpl is None else shift_in(
        torch.zeros((1, N, B), dtype=torch.int32, device=dev), ring.tpl)
    if ring.kind == "link":
        # slot 0's leader: the end-lane tail
        s0 = ring.s0
        tail_ex = s0[S0_EX] > 0.5
        lead_spd[0] = s0[S0_SPD]
        has_lead[0] = tail_ex
        if lead_tpl is not None:
            lead_tpl[0] = xla_f32_to_i32(s0[S0_TPL])
    lead_len = ring.lead_len if lead_tpl is None \
        else tpl_params_plain(lead_tpl, table, (P_LEN,))[0]
    gap = lead_dis - lead_len - ring.dis
    out = dict(gap=gap, lead_spd=lead_spd, has_lead=has_lead)
    if lead_tpl is not None:
        out["lead_tpl"] = lead_tpl
    if ring.kind == "link":
        fr_gap = (ring.len_row[:, None] - ring.dis[0]) + s0[S0_DIS] \
            - (ring.lead_len if lead_tpl is None else lead_len[0])
        gap[0] = torch.where(tail_ex, fr_gap, gap[0])
    else:
        out.update(lane_left=ring.len_row[:, None] - ring.dis,
                   invalid=occ & (ring.nxt < 0) & ~ring.last)
    return out


def _ring_plain(mode, prm, shape, raw, tpl, table, ring, inp):
    """The plain version in the ring-leader mode."""
    views = {k: v.reshape(shape) for k, v in ring_views(ring, table).items()}
    lead_tpl = views.pop("lead_tpl", None)
    got = car_follow_plain(mode, prm, shape, raw, tpl, lead_tpl, table,
                           **inp, **views)
    v = got if raw else got[0]
    if ring.kind == "lane":
        # the front slots of a lane with an in-lane take the approach rows'
        # result where that row is relevant
        AP = ring.ap_v.shape[0]
        S, N, B = ring.dis.shape
        back = torch.stack([ring.ap_v, ring.ap_rel.to(torch.float32)]
                           + ([] if raw else [ring.ap_d]), dim=1) \
            .reshape(-1, ring.ap_v[0].numel() // B, B)
        got_b = gather_rows_plain(back, ring.in_inv, 0.0)
        C = back.shape[0] // AP
        has_inv = (ring.in_inv >= 0)[:, None]
        v = v.reshape(S, N, B).clone()
        dis = None if raw else (ring.dis + got[1].reshape(S, N, B))
        for a in range(AP):
            use = has_inv & (got_b[C * a + 1] > 0)
            v[a] = torch.where(use, got_b[C * a], v[a])
            if not raw:
                dis[a] = torch.where(use, got_b[C * a + 2], dis[a])
        v = v.reshape(shape)
        if raw:
            return v
        return v, got[1], dis.reshape(shape)
    if raw:
        return v
    return v, got[1], ring.dis.reshape(shape) + got[1]


def car_follow_plain(mode, prm, shape, raw=False, tpl=None, lead_tpl=None,
                     table=None, ring=None, **inp):
    """Plain PyTorch version: isr_speed / min_chain of the JAX ring step."""
    if ring is not None:
        return _ring_plain(mode, prm, shape, raw, tpl, table, ring, inp)
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


def _dims(shape):
    """The call's shape as the kernel's four dimensions (S, d1, d2, d3):
    the leading axis, then the rest with 1s in front. The kernel takes at
    most 4 dims and indexes in 32 bits (the plain version takes any)."""
    if not 1 <= len(shape) <= 4:
        raise ValueError(f"car_follow: shape {shape} has {len(shape)} dims, "
                         "expected 1 to 4")
    n = 1
    for d in shape:
        n *= d
    if n >= 2 ** 31:
        raise ValueError(f"car_follow: {n} elements, the kernel indexes "
                         "in 32 bits")
    return (shape[0],) + (1,) * (4 - len(shape)) + tuple(shape[1:])


def _view(x, shape, name):
    """Input `x` as the kernel reads it: its element strides over the
    call's four dimensions, 0 where it broadcasts (a Python scalar: every
    element reads the value)."""
    if not torch.is_tensor(x):
        return _View(None, (ctypes.c_int * 4)(0, 0, 0, 0), float(x), 0)
    if x.dtype not in (torch.float32, torch.bool):
        raise ValueError(f"car_follow: {name} has dtype {x.dtype}")
    try:
        st = torch.broadcast_to(x, shape).stride()
    except RuntimeError:
        raise ValueError(f"car_follow: {name} {tuple(x.shape)} does not "
                         f"broadcast to {tuple(shape)}") from None
    st4 = (st[0],) + (0,) * (4 - len(shape)) + tuple(st[1:])
    return _View(x.data_ptr(), (ctypes.c_int * 4)(*st4), 0.0,
                 int(x.dtype == torch.bool))


def _check_tpl(mode, shape, tpl, lead_tpl, table, ring=None):
    if tpl is None:
        if lead_tpl is not None or table is not None:
            raise ValueError("car_follow: lead_tpl / table without tpl")
        return []
    need = [tpl] + ([lead_tpl] if mode & 2 and ring is None else [])
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


def _check_ring(ring, mode, shape, raw, tpl, lead_tpl, inp):
    """The ring-leader mode's tensors, checked."""
    if not mode & 2 or lead_tpl is not None or ring.kind not in RING_VIEWS:
        raise ValueError("car_follow: the ring-leader mode is min_chain's, "
                         "with no lead_tpl")
    given = set(RING_VIEWS[ring.kind]) & set(inp)
    if given:
        raise ValueError(f"car_follow: {sorted(given)} come from the ring")
    S, N, B = ring.dis.shape
    n = 1
    for d in shape:
        n *= d
    if n != S * N * B or shape[0] != S or shape[-1] != B \
            or tuple(ring.speed.shape) != (S, N, B) \
            or tuple(ring.n.shape) != (N, B) \
            or tuple(ring.len_row.shape) != (N,) \
            or (tpl is None) != (ring.tpl is None):
        raise ValueError("car_follow: ring shapes")
    f32, i32, b8 = (torch.float32,), (torch.int32,), (torch.bool,)
    if ring.kind == "lane":
        aps = [ring.ap_v, ring.ap_rel] + ([] if raw else [ring.ap_d])
        if any(t is None for t in aps) or ring.nxt is None \
                or ring.last is None or ring.in_inv is None \
                or tuple(ring.in_inv.shape) != (N,) \
                or len({tuple(t.shape) for t in aps}) != 1 \
                or ring.ap_v.shape[-1] != B:
            raise ValueError("car_follow: lane ring inputs")
        tens = [ring.nxt, ring.last, ring.in_inv, ring.ap_v, ring.ap_rel,
                None if raw else ring.ap_d]
        dts = [i32, b8, i32, f32, b8, f32]
    else:
        if ring.s0 is None or ring.s0.dim() != 3 \
                or tuple(ring.s0.shape[1:]) != (N, B) \
                or ring.s0.shape[0] <= (S0_TPL if tpl is not None
                                        else S0_EX):
            raise ValueError("car_follow: link ring end-lane bundle")
        tens, dts = [ring.s0], [f32]
    return ([ring.dis, ring.speed, ring.n, ring.tpl, ring.len_row] + tens,
            [f32, f32, i32, i32, f32] + dts)


def car_follow(mode, prm, shape, raw=False, tpl=None, lead_tpl=None,
               table=None, ring=None, **inp):
    """K3 on CUDA tensors, the plain version on CPU tensors."""
    global launches, launches_lc, launches_tpl, launches_tpl_lc
    global launches_ring, launches_ring_link
    missing = _needed(mode, ring) - set(inp)
    if "v_yield" in inp and mode != 2:
        raise ValueError("car_follow: v_yield goes with mode 2")
    if missing:
        raise ValueError(f"car_follow: missing inputs {sorted(missing)}")
    shape = tuple(shape)
    cpu = inp["speed"].device.type == "cpu"
    tens = [v for v in inp.values() if torch.is_tensor(v)]
    tens += _check_tpl(mode, shape, tpl, lead_tpl, table, ring)
    _lib.check_args("car_follow", *tens, cuda=not cpu)
    if ring is not None:
        rt, rdt = _check_ring(ring, mode, shape, raw, tpl, lead_tpl, inp)
        _lib.check_args("car_follow", *rt, dtypes=rdt, cuda=not cpu)
    if cpu:
        return car_follow_plain(mode, prm, shape, raw, tpl, lead_tpl, table,
                                ring, **inp)
    dims = _dims(shape)
    views = [_view(inp[k] if k in inp else 0.0, shape, k) for k in INPUTS]
    dev = inp["speed"].device
    out_v = torch.empty(shape, dtype=torch.float32, device=dev)
    out_d = out_r = out_dis = None
    if mode == 1:
        out_r = torch.empty(shape, dtype=torch.bool, device=dev)
    elif not raw:
        out_d = torch.empty(shape, dtype=torch.float32, device=dev)
        if ring is not None:
            out_dis = torch.empty(shape, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    r = ring
    lane = r is not None and r.kind == "lane"
    a = _Args((_View * len(INPUTS))(*views), out_v.data_ptr(), ptr(out_d),
              ptr(out_r), (ctypes.c_int * 4)(*dims), mode, int(raw),
              *(float(prm[i]) for i in range(len(PARAMS))),
              int("v_yield" in inp), ptr(tpl),
              ptr(lead_tpl if mode & 2 and r is None else None), ptr(table),
              0 if table is None else table.shape[0],
              0 if r is None else (1 if lane else 2),
              *(ptr(None if r is None else getattr(r, k))
                for k in ("dis", "speed", "tpl", "n", "len_row")),
              0.0 if r is None else float(r.lead_len), ptr(out_dis),
              *(ptr(getattr(r, k)) if lane and (k != "ap_d" or not raw)
                else None for k in ("nxt", "last", "in_inv", "ap_v", "ap_d",
                                    "ap_rel")),
              r.ap_v.shape[0] if lane else 0,
              r.ap_v[0].numel() // r.dis.shape[2] if lane else 0,
              ptr(r.s0 if r is not None and not lane else None),
              S0_DIS, S0_SPD, S0_EX, S0_TPL)
    rc = _lib.lib().car_follow(ctypes.byref(a), _lib.stream_ptr(out_v))
    _lib.check(rc, "car_follow")
    launches += 1
    launches_lc += "v_yield" in inp
    launches_tpl += tpl is not None
    launches_tpl_lc += tpl is not None and "v_yield" in inp
    launches_ring += r is not None
    launches_ring_link += r is not None and not lane
    if mode == 1:
        return out_v, out_r
    if raw:
        return out_v
    return (out_v, out_d) if r is None else (out_v, out_d, out_dis)
