"""G1 arrange: the per-drivable vehicle order of the gen-1 step
(csrc/arrange.cu), for B envs at once (one env is B = 1).

Inputs over the V slots of each env, (B, V):
running (bool), drv (i32), dis (float64 in exact mode, float32 in fast
mode), list_seq (i32); D drivables, the first L of them lanes (shared by
every env). Returns a dict, each entry with the env axis B in front:

  sorted_idx     (V,) slots by (drivable, -dis, list_seq, slot), the
                 slots that are not running last, in slot order
  leader         (V,) the running vehicle just ahead on the same drivable
                 (-1: none, and for slots that are not running)
  first_of, last_of  (D,) front and rear vehicle per drivable (-1: empty)
  drv_off        (D + 1,) i32 each drivable's first position in
                 sorted_idx, drv_off[D] the env's running count: lanelink
                 ll's r-th vehicle is sorted_idx[drv_off[L + ll] + r]
  overflow_link  () bool: a lanelink holds more than k_link vehicles

Slot indices are local to their env. -dis is ordered as lax.sort orders
floats: -0.0 ties with +0.0 (the next key decides) and every NaN ties
after +inf (core/step.sort_key). The JAX package's arrangement also
returns the sorted drivables, each slot's rank, per-link distance /
length tables and, given the attribute packs, the per-lanelink tables of
the first k_link vehicles and their packs; the port returns drv_off in
their place (G3 reads its candidates through sorted_idx and drv_off, and
their attributes from the state's leaves), and its sorted_idx and leader
differ from JAX's only on slots that are not running (which JAX orders
by their stale list_seq and chains as leaders).
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import _scat_drop, egat, sort_key
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_f32 = 0       # the float32 (fast-mode) launches among them


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "running", "drv", "dis", "list_seq", "zeroed", "work", "rec",
        "sorted_idx", "leader", "first_of", "last_of", "drv_off",
        "overflow")]
        + [(n, ctypes.c_longlong) for n in ("B", "V", "D", "L", "k_link",
                                            "NZ", "NW", "fp32")])

# csrc/arrange.cu: slots a tile (count and place) and its warps, counts a
# chunk (scan)
TILE, WARPS, CHUNK = 1024, 8, 4096


def arrange_plain(running, drv, dis, list_seq, D, L, k_link):
    """Plain PyTorch version: three stable sorts along each env's slots
    (least significant key first), then JAX's shifted compares, cummax and
    drop-row scatters; drv_off from each env's per-drivable counts."""
    B, V = running.shape
    dev = running.device
    key_drv = torch.where(running, drv, D).long()
    nd = torch.where(running, -dis, torch.zeros_like(dis))
    ls = torch.where(running, list_seq, 0)
    srt = lambda k: torch.sort(k, dim=-1, stable=True).indices
    o = srt(ls)
    o = o.gather(-1, srt(sort_key(nd).gather(-1, o)))
    o = o.gather(-1, srt(key_drv.gather(-1, o)))
    s_idx = o.to(torch.int32)
    s_drv = key_drv.gather(-1, o)
    valid = s_drv < D
    no = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    prev_same = torch.cat([no, s_drv[:, 1:] == s_drv[:, :-1]], -1) & valid
    next_same = torch.cat([s_drv[:, :-1] == s_drv[:, 1:], no], -1) & valid
    leader = torch.empty((B, V), dtype=torch.int32, device=dev).scatter_(
        -1, o, torch.where(prev_same, torch.roll(s_idx, 1, -1), -1))
    first_mask = valid & ~prev_same
    last_mask = valid & ~next_same

    def per_drv(mask):
        out = torch.full((B, D), -1, dtype=torch.int32, device=dev)
        return _scat_drop(out, torch.where(mask, s_drv, D), s_idx)
    cnt = torch.zeros((B, D + 1), dtype=torch.int32, device=dev).scatter_add_(
        -1, key_drv, torch.ones_like(key_drv, dtype=torch.int32))[:, :D]
    drv_off = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                         torch.cumsum(cnt, -1, dtype=torch.int32)], -1)
    return dict(leader=leader, first_of=per_drv(first_mask),
                last_of=per_drv(last_mask), sorted_idx=s_idx,
                drv_off=drv_off,
                overflow_link=torch.any(cnt[:, L:] > k_link, -1))


def link_rows(arr, L, LL, k_link):
    """Each lanelink's first k_link vehicles as G1's outputs give them,
    (B, LL, k_link) slots, -1 past the lanelink's count: the JAX
    package's link_veh table (for the plain versions and the tests; the
    kernels read sorted_idx at drv_off in place)."""
    off = arr["drv_off"]
    lo = off[:, L:L + LL]
    cnt = off[:, L + 1:L + LL + 1] - lo
    r = torch.arange(k_link, dtype=torch.int32, device=off.device)
    ok = r < cnt[..., None]
    pos = torch.where(ok, lo[..., None] + r, 0)
    return torch.where(ok, egat(arr["sorted_idx"], pos), -1)


def arrange(running, drv, dis, list_seq, D, L, k_link):
    """G1 on CUDA tensors, the plain version on CPU tensors."""
    cpu = running.device.type == "cpu"
    _lib.check_args("arrange", running, drv, dis, list_seq,
                    dtypes=[(torch.bool,), (torch.int32,), _lib.FLOATS,
                            (torch.int32,)], cuda=not cpu)
    fp32 = _lib.fp32("arrange", dis)
    lead = tuple(running.shape)
    if len(lead) != 2:
        raise ValueError(f"arrange: running {lead} is not (B, V)")
    for i, t in enumerate((drv, dis, list_seq)):
        if tuple(t.shape) != lead:
            raise ValueError(f"arrange: input {i + 1} {tuple(t.shape)} != "
                             f"{lead}")
    if cpu:
        return arrange_plain(running, drv, dis, list_seq, D, L, k_link)
    return _launch(running, drv, dis, list_seq, D, L, k_link, fp32)


def _launch(running, drv, dis, list_seq, D, L, k_link, fp32):
    global launches, launches_f32
    B, V = running.shape
    dev = running.device
    i32 = dict(dtype=torch.int32, device=dev)
    nch = (D + CHUNK) // CHUNK
    # counters, overflow, ticket, the scan's 64-bit look-back words, the
    # place's cursors
    NZ = -(-(((D + 4) & ~1) + 2 * nch + D + 1) // 4) * 4
    NW = max(-(-V // TILE), 1) * WARPS
    zeroed = torch.empty(B * NZ, **i32)       # zeroed by the launcher
    work = torch.empty(B * NW, **i32)
    # the sort records: 16 bytes in float32, 24 in float64
    rec = torch.empty((B, V, 4 if fp32 else 6), **i32)
    out = dict(leader=torch.empty((B, V), **i32),
               first_of=torch.empty((B, D), **i32),
               last_of=torch.empty((B, D), **i32),
               sorted_idx=torch.empty((B, V), **i32),
               drv_off=torch.empty((B, D + 1), **i32),
               overflow_link=torch.empty(B, dtype=torch.bool, device=dev))
    a = _Args(*(t.data_ptr() for t in (
        running, drv, dis, list_seq, zeroed, work, rec, out["sorted_idx"],
        out["leader"], out["first_of"], out["last_of"], out["drv_off"],
        out["overflow_link"])), B, V, D, L, k_link, NZ, NW, fp32)
    _lib.check(_lib.lib().arrange(ctypes.byref(a), _lib.stream_ptr(dis)),
               "arrange")
    launches += 1
    launches_f32 += fp32
    return out
