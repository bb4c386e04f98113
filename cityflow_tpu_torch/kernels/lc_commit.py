"""G8 lc_commit: the lane-change parts of the gen-1 getAction and
Vehicle::update (csrc/lc_commit.cu), in two modes:

  tail    lc_commit("tail", st, buf_drv, new_speed, end, net, L): the
          shadows that abort, the changing reals' new lateral offset and
          the ones that finish; dict(offset, finish, abort, end), end
          widened by both (JAX core/step.py:807-826)
  commit  lc_commit("commit", st, removed, finish, offset): lc_commit of
          the JAX package (:909-942) on the state after Vehicle::update:
          the promoted shadows' uid, the unlinked pairs, the offset
          reset and clearSignal; dict of the ten SimState leaves it
          writes

`st` is the gen-1 SimState of B envs ((B, V) leaves; float64, or float32
in fast mode; one env is B = 1), every per-slot argument and output
(B, V). The kernel reads a slot's partner through the partner link, a
slot index local to its env, which the step keeps symmetric; the plain
version scatters the promoted uids as the JAX package does, each env
within its own row.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import _scat_drop, egat, gat
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_tail = launches_commit = 0
launches_f32 = 0       # float32 (fast-mode) launches, both modes
MODES = ("tail", "commit")
TAIL_IN = ("running", "is_shadow", "lc_changing", "partner", "drv")
TAIL_OUT = ("offset", "finish", "abort", "end")
COMMIT_IN = ("uid", "lc_finished", "lc_has_signal", "lc_last_dir")
COMMIT_OUT = ("uid", "is_shadow", "partner", "offset", "lc_changing",
              "lc_finished", "lc_last_dir", "lc_recv", "lc_has_signal",
              "lc_target")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        TAIL_IN + ("buf_drv", "offset", "new_speed", "lc_dir", "lc_target",
                   "end", "lane_width", "interval", "offset_out", "finish",
                   "abort_", "end_out", "removed")
        + COMMIT_IN + ("c_finish", "c_offset")
        + tuple(k + "_out" if k != "offset" else "offset_c_out"
                for k in COMMIT_OUT))]
        + [(n, ctypes.c_longlong) for n in ("B", "V", "L", "fp32")])


def _tail_plain(st, buf_drv, new_speed, end, net):
    f = st.dis.dtype
    m = st.running
    changed = m & (buf_drv != st.drv)
    abort = m & st.is_shadow & changed & (st.partner >= 0)
    chg = m & st.lc_changing & ~st.is_shadow & (st.partner >= 0)
    dirn = st.lc_dir.to(f)
    one = torch.ones((), dtype=f, device=st.dis.device)
    new_off = torch.abs(st.offset + torch.maximum(0.2 * new_speed, one)
                        * net["interval"] * dirn)
    cur_w = gat(net["lane_width"], st.drv)
    tgt_w = gat(net["lane_width"], st.lc_target)
    max_off = (tgt_w + cur_w) / 2
    new_off = torch.minimum(new_off, max_off)
    finish = chg & (new_off >= max_off) & ~egat(abort, st.partner)
    return dict(offset=torch.where(chg, new_off * dirn, st.offset),
                finish=finish, abort=abort, end=end | abort | finish)


def _commit_plain(st, removed, finish, offset):
    V = st.dis.shape[-1]
    shadow = torch.where(finish, st.partner, V)
    uid = _scat_drop(st.uid, shadow, torch.where(finish, st.uid, -1))
    promote = _scat_drop(torch.zeros_like(finish), shadow, finish)
    dead = (st.partner >= 0) & egat(removed, st.partner)
    changing = torch.where(dead | removed, False, st.lc_changing)
    return dict(
        uid=uid, is_shadow=torch.where(promote | dead, False, st.is_shadow),
        partner=torch.where(promote | dead | removed, -1, st.partner),
        offset=torch.where(dead | removed | promote, 0.0, offset),
        lc_changing=changing, lc_finished=st.lc_finished | finish,
        lc_last_dir=torch.where(st.running, st.lc_dir, st.lc_last_dir),
        lc_recv=torch.full_like(st.lc_recv, -1),
        lc_has_signal=torch.where(changing, st.lc_has_signal, False),
        lc_target=torch.where(changing, st.lc_target, -1))


def lc_commit_plain(mode, st, *args):
    """Plain PyTorch version: the JAX package's slabs, (B, V)."""
    if mode == "tail":
        buf_drv, new_speed, end, net, _L = args
        return _tail_plain(st, buf_drv, new_speed, end, net)
    if mode == "commit":
        return _commit_plain(st, *args)
    raise ValueError(f"lc_commit: unknown mode {mode!r}")


def lc_commit(mode, st, *args):
    """G8 on CUDA tensors, the plain version on CPU tensors. Arguments
    after `st`: tail (buf_drv, new_speed, end, net, L), commit (removed,
    finish, offset)."""
    if mode not in MODES:
        raise ValueError(f"lc_commit: unknown mode {mode!r}")
    cpu = st.dis.device.type == "cpu"
    i32, f64, b8 = (torch.int32,), _lib.FLOATS, (torch.bool,)
    state = [getattr(st, k) for k in TAIL_IN + COMMIT_IN
             + ("offset", "lc_dir", "lc_target")]
    if mode == "tail":
        buf_drv, new_speed, end, net, L = args
        slot = (buf_drv, new_speed, end)
        extra = (net["lane_width"], net["interval"])
        dtypes = [i32, f64, b8, f64, f64]
    else:
        slot = args
        extra = ()
        dtypes = [b8, b8, f64]
    _lib.check_args("lc_commit", *slot, *extra, *state,
                    dtypes=dtypes + [b8, b8, b8, i32, i32, i32, b8, b8, i32,
                                     f64, i32, i32], cuda=not cpu)
    if st.dis.dim() != 2 or any(tuple(t.shape) != tuple(st.dis.shape)
                                for t in slot + tuple(state)):
        raise ValueError("lc_commit: per-slot inputs must be (B, V)")
    if cpu:
        return lc_commit_plain(mode, st, *args)
    return _launch(mode, st, args)


def _launch(mode, st, args):
    global launches, launches_tail, launches_commit, launches_f32
    B, V = st.dis.shape
    dev = st.dis.device
    e = lambda like: torch.empty_like(like)
    b = lambda: torch.empty((B, V), dtype=torch.bool, device=dev)
    P = {k: getattr(st, k).data_ptr() for k in TAIL_IN + COMMIT_IN
         + ("offset", "lc_dir", "lc_target")}
    if mode == "tail":
        buf_drv, new_speed, end, net, L = args
        out = dict(offset=e(st.offset), finish=b(), abort=b(), end=b())
        ptrs = [P[k] for k in TAIL_IN] + [
            buf_drv.data_ptr(), P["offset"], new_speed.data_ptr(),
            P["lc_dir"], P["lc_target"], end.data_ptr(),
            net["lane_width"].data_ptr(), net["interval"].data_ptr()] + [
            out[k].data_ptr() for k in TAIL_OUT] + [None] * (
            1 + len(COMMIT_IN) + 2 + len(COMMIT_OUT))
    else:
        removed, finish, offset = args
        L = 1
        out = {k: e(getattr(st, k)) for k in COMMIT_OUT}
        ptrs = [P[k] for k in TAIL_IN] + [
            None, None, None, P["lc_dir"], P["lc_target"], None, None,
            None] + [None] * len(TAIL_OUT) + [removed.data_ptr()] + [
            P[k] for k in COMMIT_IN] + [finish.data_ptr(),
                                        offset.data_ptr()] + [
            out[k].data_ptr() for k in COMMIT_OUT]
    fp32 = int(st.dis.dtype == torch.float32)
    a = _Args(*ptrs, B, V, L, fp32)
    _lib.check(_lib.lib().lc_commit(ctypes.byref(a), MODES.index(mode),
                                    _lib.stream_ptr(st.dis)), "lc_commit")
    launches += 1
    launches_f32 += fp32
    if mode == "tail":
        launches_tail += 1
    else:
        launches_commit += 1
    return out
