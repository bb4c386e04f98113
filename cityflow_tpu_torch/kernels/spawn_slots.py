"""G11 spawn_slots: the spawn phase of the gen-1 step (csrc/spawn_slots.cu),
Flow::nextStep + Engine::planRoute's valid path (flow.cpp:6-22,
engine.cpp:450-470), for B envs at once (one env is B = 1).

Each env reads max_spawn_per_step (MS) rows of the shared spawn table from
its cursor (clamped so the rows fit, as dynamic_slice clamps); the rows
whose step is the env's step go, in order, into the env's first free slots
in slot order (jnp.nonzero(~active, size=MS) order), a row with no free
slot left sets OV_SLOTS. A filled slot takes the row's first drivable,
route, priority and flow parameters, uid cursor + k, the entry time step *
interval, and every other per-slot leaf its empty value (SLOT_FILL), active
True.

spawn_slots(st, spawn_tbl, flow_params, interval, MS, inplace=False) takes
a SimState of B envs ((B, V) leaves, (B,) scalars), the spawn table
{step, flow, priority, first_drv, route} (n,) i32, flow_params (NF, 12)
and the 0-dim interval in the state's float dtype. It returns the per-slot
leaves, spawn_cursor and overflow after the spawn:
  - inplace=False (the copying form: the caller keeps its state): new
    tensors, the state is not written;
  - inplace=True (the caller donates its state): the state's own tensors,
    written in place, only the spawned rows of the pool and the two
    scalars; the leaves and scalars must not overlap in memory.
The in-place launches count apart as spawn_slots@inplace.
"""

import ctypes
import math

import numpy as np
import torch

from cityflow_tpu_torch.core.state import OV_SLOTS, SLOT_FILL
from cityflow_tpu_torch.core.step import P_SPEED, _first_true, _scat_drop, gat
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_f32 = 0       # float32 (fast-mode) launches among them
launches_inplace = 0   # in-place launches among them
ROWS = ("step", "flow", "priority", "first_drv", "route")
LEAVES = tuple(SLOT_FILL)        # every per-slot leaf, params among them
# what a spawned slot holds, where it is not the leaf's SLOT_FILL value
K_CONST, K_SPEED, K_DRV, K_ROUTE, K_ENTER, K_PRIORITY, K_UID, K_PARAMS = \
    range(8)
KIND = {"speed": K_SPEED, "drv": K_DRV, "route": K_ROUTE,
        "enter_time": K_ENTER, "priority": K_PRIORITY, "uid": K_UID,
        "params": K_PARAMS}
SPAWN_FILL = dict(SLOT_FILL, active=True)
MAX_LEAVES = 40


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "step", "cursor", "overflow", "active", "t_step", "t_flow",
        "t_priority", "t_first_drv", "t_route", "flow_params", "interval",
        "tgt", "cursor_out", "overflow_out")]
        + [("src", ctypes.c_void_p * MAX_LEAVES),
           ("dst", ctypes.c_void_p * MAX_LEAVES),
           ("width", ctypes.c_longlong * MAX_LEAVES),
           ("kind", ctypes.c_longlong * MAX_LEAVES),
           ("cbits", ctypes.c_longlong * MAX_LEAVES)]
        + [(n, ctypes.c_longlong) for n in (
            "B", "V", "MS", "n", "NF", "NP", "nleaf", "fp32")])


class _Leaf(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("width", ctypes.c_int),
                ("kind", ctypes.c_int), ("cbits", ctypes.c_longlong)]


class _InArgs(ctypes.Structure):
    _fields_ = ([("leaf", _Leaf * MAX_LEAVES)]
                + [(n, ctypes.c_void_p) for n in (
                    "step", "cursor", "overflow", "active", "t_step",
                    "t_flow", "t_priority", "t_first_drv", "t_route",
                    "flow_params", "interval", "tgt")]
                + [(n, ctypes.c_int) for n in (
                    "B", "V", "MS", "n", "NF", "NP", "nleaf", "fp32")])


def spawn_slots_plain(st, spawn_tbl, flow_params, interval, MS,
                      inplace=False):
    """Plain PyTorch version: the JAX package's spawn_vehicles, each env
    along its own slot axis (an int-cumsum compaction for the free slots),
    then one drop-row scatter per leaf (copying form) or, in place, one
    index_put_ per leaf of the spawned rows (a boolean mask picks them: a
    host sync, which the kernel does not make)."""
    B, V = st.active.shape
    dev = st.dis.device
    n = spawn_tbl["step"].shape[0]
    # dynamic_slice clamps its start so the slice fits
    start = st.spawn_cursor.clamp(0, n - MS)
    ar = torch.arange(MS, dtype=torch.int32, device=dev)
    ridx = start[:, None] + ar
    rows = {k: gat(spawn_tbl[k], ridx) for k in ROWS}
    want = rows["step"] == st.step[:, None]          # contiguous prefix
    free = _first_true(~st.active, MS)
    slot = torch.where(want, free, -1)
    ok = want & (slot >= 0)
    ov = torch.any(want & (slot < 0), -1)
    f = st.dis.dtype
    fp = gat(flow_params, rows["flow"]).to(f)         # (B, MS, NP)
    val = dict(SPAWN_FILL, speed=fp[..., P_SPEED], drv=rows["first_drv"],
               route=rows["route"], priority=rows["priority"],
               uid=st.spawn_cursor[:, None] + ar, params=fp,
               enter_time=(st.step.to(f) * interval)[:, None])
    cursor = st.spawn_cursor + want.sum(-1, dtype=torch.int32)
    overflow = st.overflow | torch.where(ov, OV_SLOTS, 0).to(torch.int32)
    if not inplace:
        tgt = torch.where(ok, slot, V)               # drop-mode scatter
        out = {k: _scat_drop(getattr(st, k), tgt, val[k]) for k in LEAVES}
        out["spawn_cursor"], out["overflow"] = cursor, overflow
        return out
    env, k = torch.nonzero(ok, as_tuple=True)
    dst = slot[env, k].long()
    for key in LEAVES:
        leaf = getattr(st, key)
        v = torch.as_tensor(val[key], dtype=leaf.dtype, device=dev)
        v = v.expand((B, MS) + tuple(leaf.shape[2:]))
        leaf[env, dst] = v[env, k]
    st.spawn_cursor.copy_(cursor)
    st.overflow.copy_(overflow)
    return _state_out(st)


def _state_out(st):
    out = {k: getattr(st, k) for k in LEAVES}
    out["spawn_cursor"], out["overflow"] = st.spawn_cursor, st.overflow
    return out


def _bits(v, dtype):
    """The fill value's bit pattern in `dtype`, as a signed 64-bit int."""
    npd = {torch.bool: np.uint8, torch.int32: np.int32,
           torch.float32: np.float32, torch.float64: np.float64}[dtype]
    raw = np.zeros(8, np.uint8)
    b = np.array([v], npd).view(np.uint8)
    raw[:b.size] = b
    return int(raw.view(np.int64)[0])


def spawn_slots(st, spawn_tbl, flow_params, interval, MS, inplace=False):
    """G11 on CUDA tensors, the plain version on CPU tensors."""
    cpu = st.dis.device.type == "cpu"
    leaves = [getattr(st, k) for k in LEAVES]
    tbl = [spawn_tbl[k] for k in ROWS]
    i32 = (torch.int32,)
    _lib.check_args("spawn_slots", st.step, st.spawn_cursor, st.overflow,
                    *tbl, flow_params, interval, st.dis, st.params,
                    dtypes=[i32] * 8 + [_lib.FLOATS] * 4, cuda=not cpu)
    _lib.check_args("spawn_slots", *leaves, cuda=not cpu)
    lead = tuple(st.step.shape)
    V = st.active.shape[-1]
    if len(lead) != 1 or any(tuple(t.shape[:2]) != lead + (V,)
                             for t in leaves):
        raise ValueError("spawn_slots: per-slot leaves must be (B, V, ...) "
                         "with the scalars (B,)")
    if tbl[0].shape[0] < MS:
        raise ValueError("spawn_slots: the spawn table is shorter than "
                         "max_spawn_per_step")
    if inplace:
        _lib.check_disjoint("spawn_slots",
                            leaves + [st.spawn_cursor, st.overflow])
    else:
        row_words_aligned(leaves)
    if cpu:
        return spawn_slots_plain(st, spawn_tbl, flow_params, interval, MS,
                                 inplace)
    if inplace:
        return _launch_inplace(st, tbl, flow_params, interval, MS)
    return _launch(st, tbl, flow_params, interval, MS)


def row_words_aligned(leaves):
    """The copying form copies each slot row in the widest word its width
    allows (csrc/gen1.cuh copy_bytes: 8, 4 or 1 bytes), so each leaf must
    start on such a word: raise where one does not (a view one element
    into its buffer). The state's own tensors always do; the in-place form
    takes any view."""
    for t in leaves:
        w = math.prod(t.shape[2:]) * t.element_size()
        word = 8 if w % 8 == 0 else (4 if w % 4 == 0 else 1)
        if t.data_ptr() % word:
            raise ValueError("spawn_slots: the copying form needs each "
                             f"leaf aligned to {word}-byte words")


def _launch(st, tbl, flow_params, interval, MS):
    global launches, launches_f32
    B, V = st.active.shape
    dev = st.dis.device
    i32 = dict(dtype=torch.int32, device=dev)
    out = {k: torch.empty_like(getattr(st, k)) for k in LEAVES}
    out["spawn_cursor"] = torch.empty(B, **i32)
    out["overflow"] = torch.empty(B, **i32)
    tgt = torch.empty((B, max(MS, 1)), **i32)
    a = _Args(*(t.data_ptr() for t in (
        st.step, st.spawn_cursor, st.overflow, st.active, *tbl, flow_params,
        interval, tgt, out["spawn_cursor"], out["overflow"])))
    for i, k in enumerate(LEAVES):
        src = getattr(st, k)
        a.src[i] = src.data_ptr()
        a.dst[i] = out[k].data_ptr()
        a.width[i] = src[0, 0].numel() * src.element_size()
        a.kind[i] = KIND.get(k, K_CONST)
        a.cbits[i] = _bits(SPAWN_FILL[k], src.dtype) if k not in KIND else 0
    a.B, a.V, a.MS, a.n = B, V, MS, tbl[0].shape[0]
    a.NF, a.NP = flow_params.shape
    a.nleaf = len(LEAVES)
    a.fp32 = _lib.fp32("spawn_slots", st.dis, st.params, flow_params,
                       interval)
    _lib.check(_lib.lib().spawn_slots(ctypes.byref(a), _lib.stream_ptr(
        st.dis)), "spawn_slots")
    launches += 1
    launches_f32 += a.fp32
    return out


def _launch_inplace(st, tbl, flow_params, interval, MS):
    global launches, launches_f32, launches_inplace
    B, V = st.active.shape
    tgt = torch.empty((B, max(MS, 1)), dtype=torch.int32,
                      device=st.dis.device)
    a = _InArgs()
    for i, k in enumerate(LEAVES):
        t = getattr(st, k)
        L = a.leaf[i]
        L.p = t.data_ptr()
        L.width = t[0, 0].numel() * t.element_size()
        L.kind = KIND.get(k, K_CONST)
        L.cbits = _bits(SPAWN_FILL[k], t.dtype) if k not in KIND else 0
    for n, t in zip(("step", "cursor", "overflow", "active", "t_step",
                     "t_flow", "t_priority", "t_first_drv", "t_route",
                     "flow_params", "interval", "tgt"),
                    (st.step, st.spawn_cursor, st.overflow, st.active, *tbl,
                     flow_params, interval, tgt)):
        setattr(a, n, t.data_ptr())
    a.B, a.V, a.MS, a.n = B, V, MS, tbl[0].shape[0]
    a.NF, a.NP = flow_params.shape
    a.nleaf = len(LEAVES)
    a.fp32 = _lib.fp32("spawn_slots", st.dis, st.params, flow_params,
                       interval)
    _lib.check(_lib.lib().spawn_slots_inplace(ctypes.byref(a),
                                              _lib.stream_ptr(st.dis)),
               "spawn_slots")
    launches += 1
    launches_f32 += a.fp32
    launches_inplace += 1
    return _state_out(st)
