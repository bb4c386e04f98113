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
i32 from G7. It writes IN PLACE st2's per-slot leaves (the pairs' rows
only), seq_counter and overflow, and returns them. `st` may share tensors
with `st2` (plan_lane_change's st2 is st with the plan's fields
replaced): every value is read before it is written. A changer must be
active and a free slot is not, so no row is both read and written; the
step meets this (tests/test_torch_shadow_cases.py). A caller that keeps
`st2`'s leaves passes copies.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.state import OV_SLOTS, SLOT_FILL
from cityflow_tpu_torch.core.step import _first_true
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


SI_TILE = 256 * 16        # slots one block scans a tile (csrc: SI_THREADS)
MAX_NCH = 256             # chunks an env
I32_MAX = 2 ** 31 - 1


class _Leaf(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("width", ctypes.c_int),
                ("kind", ctypes.c_int), ("cbits", ctypes.c_longlong)]


class _Args(ctypes.Structure):
    _fields_ = ([("leaf", _Leaf * MAX_LEAVES)]
                + [(n, ctypes.c_void_p) for n in (
                    "do_change", "active", "target", "uid", "seq_in",
                    "seq_out", "overflow", "cnt", "pos")]
                + [(n, ctypes.c_int) for n in ("B", "V", "MS", "nleaf", "nch",
                                               "chunk")])


def chunks(B, V):
    """(chunks an env, slots a chunk) of the scan: about 1024 blocks over
    the B envs, a chunk a multiple of SI_TILE and at most MAX_NCH an env."""
    tiles = max(1, -(-V // SI_TILE))
    nch = min(tiles, max(1, -(-1024 // B)), MAX_NCH)
    chunk = -(-tiles // nch) * SI_TILE
    return -(-max(V, 1) // chunk), chunk


def shadow_insert_plain(st, st2, do_change, target, MS):
    """Plain PyTorch version: the JAX package's insert (lanechange.py:
    228-291) along each env's slot axis (an int-cumsum compaction for the
    changers and the free slots), in place: every new value read first,
    then written into the pairs' rows with index_put_ (a boolean mask
    picks the pairs: a host sync, which the kernel does not make)."""
    B = do_change.shape[0]
    changers = _first_true(do_change, MS)
    free = _first_true(~st.active, MS)
    ok = (changers >= 0) & (free >= 0)
    ov = torch.any((changers >= 0) & (free < 0), -1)
    env = torch.arange(B, device=ok.device)[:, None].expand(ok.shape)[ok]
    src, dst = changers[ok].long(), free[ok].long()
    uid_src = st.uid[env, src]
    val = {K_DRV: target[env, src], K_PRIORITY: SHADOW_BIT + uid_src,
           K_UID: uid_src | SHADOW_BIT, K_SEQ: st.seq_counter[env],
           K_PARTNER: src.to(torch.int32)}
    new = {}
    for k in LEAVES:
        kind = leaf_kind(k)
        new[k] = (getattr(st2, k)[env, src] if kind == K_COPY
                  else SET[k] if kind == K_CONST else val[kind])
    seq = st.seq_counter + 1
    ovf = st2.overflow | torch.where(ov, OV_SLOTS, 0).to(torch.int32)
    for k in LEAVES:
        getattr(st2, k)[env, dst] = new[k]
    st2.partner[env, src] = dst.to(torch.int32)      # link real -> shadow
    st2.seq_counter.copy_(seq)
    st2.overflow.copy_(ovf)
    return _written(st2)


def _written(st2):
    out = {k: getattr(st2, k) for k in LEAVES}
    out["seq_counter"], out["overflow"] = st2.seq_counter, st2.overflow
    return out


def offsets_fit(B, V):
    """The kernel's slot offsets are 32-bit: B * V must fit, or this
    raises (the CPU path too, so that the tests see the refusal)."""
    if B * V > I32_MAX:
        raise ValueError(f"shadow_insert: B={B} V={V} do not fit the "
                         "kernel's 32-bit offsets")


def shadow_insert(st, st2, do_change, target, MS):
    """G15 on CUDA tensors, the plain version on CPU tensors."""
    cpu = st.dis.device.type == "cpu"
    leaves = [getattr(st2, k) for k in LEAVES]
    i32, b8 = (torch.int32,), (torch.bool,)
    _lib.check_args("shadow_insert", do_change, st.active, target, st.uid,
                    st.seq_counter, st2.seq_counter, st2.overflow, st.dis,
                    st2.dis, dtypes=[b8, b8, i32, i32, i32, i32, i32,
                                     _lib.FLOATS, _lib.FLOATS], cuda=not cpu)
    _lib.check_args("shadow_insert", *leaves, cuda=not cpu)
    BV = tuple(st.active.shape)
    if len(BV) != 2 or any(tuple(t.shape[:2]) != BV for t in leaves) \
            or tuple(do_change.shape) != BV or tuple(target.shape) != BV \
            or tuple(st.uid.shape) != BV \
            or tuple(st.seq_counter.shape) != BV[:1] \
            or tuple(st2.seq_counter.shape) != BV[:1] \
            or tuple(st2.overflow.shape) != BV[:1]:
        raise ValueError("shadow_insert: per-slot leaves must be (B, V, "
                         "...) with the scalars (B,)")
    offsets_fit(*BV)
    if cpu:
        return shadow_insert_plain(st, st2, do_change, target, MS)
    return _launch(st, st2, do_change, target, MS)


def _launch(st, st2, do_change, target, MS):
    global launches, launches_f32
    B, V = st.active.shape
    nch, chunk = chunks(B, V)
    i32 = dict(dtype=torch.int32, device=st.dis.device)
    cnt = torch.empty((B, nch, 2), **i32)
    pos = torch.empty((B, nch, 2, max(MS, 1)), **i32)
    a = _Args()
    for i, k in enumerate(LEAVES):
        t = getattr(st2, k)
        L = a.leaf[i]
        L.p = t.data_ptr()
        L.width = t[0, 0].numel() * t.element_size()
        L.kind = leaf_kind(k)
        L.cbits = _bits(SET[k], t.dtype) if k in SET else 0
    for n, t in (("do_change", do_change), ("active", st.active),
                 ("target", target), ("uid", st.uid),
                 ("seq_in", st.seq_counter), ("seq_out", st2.seq_counter),
                 ("overflow", st2.overflow), ("cnt", cnt), ("pos", pos)):
        setattr(a, n, t.data_ptr())
    a.B, a.V, a.MS, a.nleaf, a.nch, a.chunk = B, V, MS, len(LEAVES), nch, \
        chunk
    fp32 = _lib.fp32("shadow_insert", st.dis, st2.dis, st2.params)
    _lib.check(_lib.lib().shadow_insert(ctypes.byref(a), _lib.stream_ptr(
        st.dis)), "shadow_insert")
    launches += 1
    launches_f32 += fp32
    return _written(st2)
