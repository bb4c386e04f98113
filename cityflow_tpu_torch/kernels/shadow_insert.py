"""G15 shadow_insert: the shadow insert of gen-1 lane change
(csrc/shadow_insert.cu), LaneChange::insertShadow (lanechange.cpp:71-102)
for B envs at once (one env is B = 1).

Per env, the first max_spawn_per_step (MS) changers (do_change) in slot
order go into the env's first MS free slots (~active before the insert)
in slot order. A shadow copies every per-slot leaf of its real (params
too) except the leaves of SET, which take the values there: its drivable
is the real's target lane, priority 2^30 + uid and uid uid | 2^30 of the
real, list_seq the env's seq_counter from before the step, partner the
real, is_shadow True, no leader or blocker, the lane-change fields
cleared. The real's partner becomes its shadow. seq_counter advances by
one in every env on every call; an env with a changer and no free slot
left sets OV_SLOTS in its own overflow.

shadow_insert(st, st2, do_change, target, MS): `st` the state before the
plan (its active flags, uids and seq_counter), `st2` the planned state
whose leaves the shadows copy, do_change (B, V) bool and target (B, V)
i32 from G7. Returns the new per-slot leaves, seq_counter and overflow
(new tensors; neither state is written).
"""

import ctypes

import torch

from cityflow_tpu_torch.core.state import OV_SLOTS, SLOT_FILL
from cityflow_tpu_torch.core.step import _first_true, _scat_drop, egat
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels.spawn_slots import MAX_LEAVES, _bits

launches = 0
launches_f32 = 0       # float32 (fast-mode) launches among them
SHADOW_BIT = 1 << 30      # shadow uid bit and priority offset
LEAVES = tuple(SLOT_FILL)        # every per-slot leaf, params among them
# what a shadow holds where it is not a copy of its real's row
K_COPY, K_CONST, K_DRV, K_PRIORITY, K_UID, K_SEQ, K_PARTNER = range(7)
KIND = {"drv": K_DRV, "priority": K_PRIORITY, "uid": K_UID,
        "list_seq": K_SEQ, "partner": K_PARTNER}
# the leaves a shadow sets to a constant (lanechange.cpp:71-102; the JAX
# package's fill values); every other leaf is its real's, the possibly
# stale gap among them: the vehicle.cpp copy constructor copies
# controllerInfo, and that gap gates makeSignal
SET = {"active": True, "running": True, "is_shadow": True, "leader": -1,
       "blocker": -1, "custom_speed": 0, "has_custom": False, "offset": 0,
       "lc_changing": False, "lc_finished": False, "lc_target": -1,
       "lc_has_signal": False, "lc_dir": 0, "lc_recv": -1,
       "lc_tleader": -1, "lc_tfollower": -1, "lc_lgap": 0, "lc_fgap": 0,
       "lc_last_dir": 0}


def leaf_kind(k):
    """How a shadow's leaf k is made: a copy of the real's row unless SET
    or KIND names it."""
    return KIND.get(k, K_CONST if k in SET else K_COPY)


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "do_change", "active", "target", "uid", "seq", "overflow", "pairs",
        "seq_out", "overflow_out")]
        + [("src", ctypes.c_void_p * MAX_LEAVES),
           ("dst", ctypes.c_void_p * MAX_LEAVES),
           ("width", ctypes.c_longlong * MAX_LEAVES),
           ("kind", ctypes.c_longlong * MAX_LEAVES),
           ("cbits", ctypes.c_longlong * MAX_LEAVES)]
        + [(n, ctypes.c_longlong) for n in ("B", "V", "MS", "nleaf",
                                            "fp32")])


def shadow_insert_plain(st, st2, do_change, target, MS):
    """Plain PyTorch version: the JAX package's insert (lanechange.py:
    228-291) along each env's slot axis: an int-cumsum compaction for the
    changers and the free slots, one drop-row scatter per leaf."""
    V = st.dis.shape[-1]
    changers = _first_true(do_change, MS)
    free = _first_true(~st.active, MS)
    ok = (changers >= 0) & (free >= 0)
    ov = torch.any((changers >= 0) & (free < 0), -1)
    src = torch.where(ok, changers, V)
    dst = torch.where(ok, free, V)
    src_c = src.clamp(0, V - 1)
    uid_src = egat(st.uid, src_c)
    val = {K_DRV: egat(target, src_c), K_PRIORITY: SHADOW_BIT + uid_src,
           K_UID: uid_src | SHADOW_BIT, K_SEQ: st.seq_counter[:, None],
           K_PARTNER: src}
    out = {}
    for k in LEAVES:
        a = getattr(st2, k)
        kind = leaf_kind(k)
        v = (egat(a, src_c) if kind == K_COPY
             else SET[k] if kind == K_CONST else val[kind])
        out[k] = _scat_drop(a, dst, v)
    # link real -> shadow
    out["partner"] = _scat_drop(out["partner"], src, dst)
    out["seq_counter"] = st.seq_counter + 1
    out["overflow"] = st2.overflow | torch.where(ov, OV_SLOTS, 0).to(
        torch.int32)
    return out


def shadow_insert(st, st2, do_change, target, MS):
    """G15 on CUDA tensors, the plain version on CPU tensors."""
    cpu = st.dis.device.type == "cpu"
    leaves = [getattr(st2, k) for k in LEAVES]
    i32, b8 = (torch.int32,), (torch.bool,)
    _lib.check_args("shadow_insert", do_change, st.active, target, st.uid,
                    st.seq_counter, st2.overflow, st.dis, st2.dis,
                    dtypes=[b8, b8, i32, i32, i32, i32, _lib.FLOATS,
                            _lib.FLOATS], cuda=not cpu)
    _lib.check_args("shadow_insert", *leaves, cuda=not cpu)
    BV = tuple(st.active.shape)
    if len(BV) != 2 or any(tuple(t.shape[:2]) != BV for t in leaves) \
            or tuple(do_change.shape) != BV or tuple(target.shape) != BV \
            or tuple(st.uid.shape) != BV \
            or tuple(st.seq_counter.shape) != BV[:1] \
            or tuple(st2.overflow.shape) != BV[:1]:
        raise ValueError("shadow_insert: per-slot leaves must be (B, V, "
                         "...) with the scalars (B,)")
    if cpu:
        return shadow_insert_plain(st, st2, do_change, target, MS)
    return _launch(st, st2, do_change, target, MS)


def _launch(st, st2, do_change, target, MS):
    global launches, launches_f32
    B, V = st.active.shape
    dev = st.dis.device
    i32 = dict(dtype=torch.int32, device=dev)
    out = {k: torch.empty_like(getattr(st2, k)) for k in LEAVES}
    out["seq_counter"] = torch.empty(B, **i32)
    out["overflow"] = torch.empty(B, **i32)
    pairs = torch.empty((B, 2, max(MS, 1)), **i32)
    a = _Args(*(t.data_ptr() for t in (
        do_change, st.active, target, st.uid, st.seq_counter, st2.overflow,
        pairs, out["seq_counter"], out["overflow"])))
    for i, k in enumerate(LEAVES):
        src = getattr(st2, k)
        a.src[i] = src.data_ptr()
        a.dst[i] = out[k].data_ptr()
        a.width[i] = src[0, 0].numel() * src.element_size()
        a.kind[i] = leaf_kind(k)
        a.cbits[i] = _bits(SET[k], src.dtype) if k in SET else 0
    a.B, a.V, a.MS, a.nleaf = B, V, MS, len(LEAVES)
    a.fp32 = _lib.fp32("shadow_insert", st.dis, st2.dis, st2.params)
    _lib.check(_lib.lib().shadow_insert(ctypes.byref(a), _lib.stream_ptr(
        st.dis)), "shadow_insert")
    launches += 1
    launches_f32 += a.fp32
    return out
