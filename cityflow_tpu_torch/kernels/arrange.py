"""G1 arrange: the per-drivable vehicle order of the gen-1 step
(csrc/arrange.cu).

Inputs over the V slots: running (bool), drv (i32), dis (float64 in
exact mode, float32 in fast mode), list_seq (i32); D drivables, the first
L of them lanes; optionally the attribute packs fattrs (V, NA) in dis's
dtype and iattrs (V, NI) i32. Returns a dict:

  sorted_idx     (V,) slots by (drivable, -dis, list_seq, slot), the
                 slots that are not running last, in slot order
  leader         (V,) the running vehicle just ahead on the same drivable
                 (-1: none, and for slots that are not running)
  first_of, last_of  (D,) front and rear vehicle per drivable (-1: empty)
  overflow_link  () bool: a lanelink holds more than k_link vehicles
  link_veh, link_fattr, link_iattr  (LLr, k_link[, NA / NI]) the first
                 k_link vehicles of each lanelink and their packs (None
                 without packs); LLr = max(D - L, 1)

-dis is ordered as lax.sort orders floats (-0.0 before +0.0, NaN last).
The JAX package's arrangement also returns the sorted drivables, each
slot's rank and per-link distance / length tables; nothing reads them in
exact mode, so the port leaves them out, and its sorted_idx and leader
differ from JAX's only on slots that are not running (which JAX orders by
their stale list_seq and chains as leaders).
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import order_key
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_f32 = 0       # the float32 (fast-mode) launches among them


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "running", "drv", "dis", "list_seq", "fattrs", "iattrs", "scratch",
        "sorted_idx", "leader", "first_of", "last_of", "link_veh",
        "link_fattr", "link_iattr", "overflow")]
        + [(n, ctypes.c_longlong) for n in ("V", "D", "L", "k_link", "NA",
                                            "NI", "fp32")])


def arrange_plain(running, drv, dis, list_seq, D, L, k_link, fattrs=None,
                  iattrs=None):
    """Plain PyTorch version: three stable sorts (least significant key
    first), then JAX's shifted compares, cummax and drop-row scatters."""
    V = running.shape[0]
    dev = running.device
    key_drv = torch.where(running, drv, D).long()
    nd = torch.where(running, -dis, torch.zeros_like(dis))
    ls = torch.where(running, list_seq, 0)
    o = torch.sort(ls, stable=True).indices
    o = o[torch.sort(order_key(nd)[o], stable=True).indices]
    o = o[torch.sort(key_drv[o], stable=True).indices]
    s_idx = o.to(torch.int32)
    s_drv = key_drv[o]
    valid = s_drv < D
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    prev_same = torch.cat([no, s_drv[1:] == s_drv[:-1]]) & valid
    next_same = torch.cat([s_drv[:-1] == s_drv[1:], no]) & valid
    leader = torch.empty(V, dtype=torch.int32, device=dev).scatter_(
        0, o, torch.where(prev_same, torch.roll(s_idx, 1), -1))
    first_mask = valid & ~prev_same
    last_mask = valid & ~next_same

    def per_drv(mask):
        out = torch.full((D + 1,), -1, dtype=torch.int32, device=dev)
        return out.scatter_(0, torch.where(mask, s_drv, D), s_idx)[:D]
    pos = torch.arange(V, device=dev)
    seg_start = torch.cummax(torch.where(first_mask, pos, -1), 0).values
    rank = pos - seg_start
    on_link = valid & (s_drv >= L)
    out = dict(leader=leader, first_of=per_drv(first_mask),
               last_of=per_drv(last_mask), sorted_idx=s_idx,
               overflow_link=torch.any(on_link & (rank >= k_link)),
               link_veh=None, link_fattr=None, link_iattr=None)
    if fattrs is not None:
        LLr = max(D - L, 1)
        nrows = LLr * k_link
        flat = torch.where(on_link & (rank < k_link),
                           (s_drv - L) * k_link + rank, nrows)

        def table(src, fill):
            t = torch.full((nrows + 1,) + tuple(src.shape[1:]), fill,
                           dtype=src.dtype, device=dev)
            return t.index_copy_(0, flat, src)[:-1].reshape(
                (LLr, k_link) + tuple(src.shape[1:]))
        out["link_veh"] = table(s_idx, -1)
        out["link_fattr"] = table(fattrs[o], 0)
        out["link_iattr"] = table(iattrs[o], 0)
    return out


def arrange(running, drv, dis, list_seq, D, L, k_link, fattrs=None,
            iattrs=None):
    """G1 on CUDA tensors, the plain version on CPU tensors."""
    cpu = running.device.type == "cpu"
    packs = fattrs is not None
    _lib.check_args("arrange", running, drv, dis, list_seq, fattrs, iattrs,
                    dtypes=[(torch.bool,), (torch.int32,), _lib.FLOATS,
                            (torch.int32,), _lib.FLOATS, (torch.int32,)],
                    cuda=not cpu)
    fp32 = _lib.fp32("arrange", dis, fattrs)
    V = running.shape[0]
    for i, t in enumerate((drv, dis, list_seq)):
        if tuple(t.shape) != (V,):
            raise ValueError(f"arrange: input {i + 1} {tuple(t.shape)} != "
                             f"{(V,)}")
    if packs and (iattrs is None or fattrs.shape[0] != V
                  or iattrs.shape[0] != V):
        raise ValueError("arrange: fattrs and iattrs must both be (V, .)")
    if cpu:
        return arrange_plain(running, drv, dis, list_seq, D, L, k_link,
                             fattrs, iattrs)
    return _launch(running, drv, dis, list_seq, D, L, k_link, fattrs, iattrs,
                   fp32)


def _launch(running, drv, dis, list_seq, D, L, k_link, fattrs, iattrs,
            fp32):
    global launches, launches_f32
    V = running.shape[0]
    packs = fattrs is not None
    dev = running.device
    i32 = dict(dtype=torch.int32, device=dev)
    scratch = torch.zeros(3 * (D + 2) + 2 * V + 1, **i32)
    sorted_idx = torch.empty(V, **i32)
    leader = torch.empty(V, **i32)
    first_of = torch.full((D,), -1, **i32)
    last_of = torch.full((D,), -1, **i32)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    LLr = max(D - L, 1)
    NA = fattrs.shape[1] if packs else 0
    NI = iattrs.shape[1] if packs else 0
    link_veh = torch.full((LLr, k_link), -1, **i32) if packs else None
    link_fattr = torch.zeros((LLr, k_link, NA), dtype=dis.dtype,
                             device=dev) if packs else None
    link_iattr = torch.zeros((LLr, k_link, NI), **i32) if packs else None
    ptr = lambda t: None if t is None else t.data_ptr()
    a = _Args(*(ptr(t) for t in (
        running, drv, dis, list_seq, fattrs, iattrs, scratch, sorted_idx,
        leader, first_of, last_of, link_veh, link_fattr, link_iattr,
        overflow)), V, D, L, k_link, NA, NI, fp32)
    _lib.check(_lib.lib().arrange(ctypes.byref(a), _lib.stream_ptr(dis)),
               "arrange")
    launches += 1
    launches_f32 += fp32
    return dict(leader=leader, first_of=first_of, last_of=last_of,
                sorted_idx=sorted_idx, overflow_link=overflow,
                link_veh=link_veh, link_fattr=link_fattr,
                link_iattr=link_iattr)
