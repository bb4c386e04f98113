"""G10 update_location: the finish statistics and the transfer order of
the gen-1 step (csrc/update_location.cu), Engine::threadUpdateLocation and
the main-stage push (engine.cpp:282-315, 477-494).

For B envs at once (one env is B = 1): per-slot inputs (B, V), the
per-env scalars (B,), and so the outputs. Per slot: running,
end, changed (bool), buf_dis, enter_time (float), buf_drv, list_seq,
enter_ll_time (i32); G1's sorted_idx i32 (exact mode only, else None);
lc_finished and finish (bool, under lane change, else None). Per env:
step, seq_counter, finished_cnt, overflow (i32), cum_travel (float); the
interval 0-dim (float). Floats are float64 (exact) or float32
(fast), one dtype per call.

Returns dict(removed (B, V) bool, list_seq, enter_ll_time (B, V) i32,
finished_cnt, cum_travel, seq_counter, overflow (B,)):

- removed = running & end; the counted removals leave out a finished lane
  change (an identity swap, engine.cpp:299-303). Exact: the travel times
  of the first max_remove counted slots in G1's order, added left to
  right from 0, then to cum_travel; OV_REMOVE when more were counted.
  Fast: the sum over every counted slot (the plain version is JAX's
  torch.sum; the kernel a fixed order of its own, close to it, the same
  on every run).
- a transferring slot (running, changed, not removed) gets list ticket
  seq_counter + its rank by -buf_dis among the transferring slots, ties
  by slot, -0.0 equal to 0.0 (a stable sort's order), and enter_ll_time
  the step on a lanelink (buf_drv >= L), INT_MAX on a lane;
  seq_counter grows by the transfers.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.state import INT_MAX, OV_REMOVE
from cityflow_tpu_torch.core.step import _first_true
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_fast = 0      # fast-mode launches among them
launches_f32 = 0       # float32 launches among them
SLOTS = ("running", "end", "changed", "buf_dis", "buf_drv", "enter_time",
         "list_seq", "enter_ll_time", "sorted_idx", "lc_finished", "finish")
SCALARS = ("step", "seq_counter", "finished_cnt", "cum_travel", "overflow",
           "interval")
OUT = ("removed", "list_seq", "enter_ll_time", "finished_cnt",
       "cum_travel", "seq_counter", "overflow")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        SLOTS + SCALARS + ("removed", "list_seq_out", "enter_ll_out",
                           "finished_out", "cum_out", "seq_out",
                           "overflow_out", "flags", "iscratch", "vals"))]
        + [(n, ctypes.c_longlong) for n in ("B", "V", "R", "L", "exact",
                                            "fp32")])


def update_location_plain(running, end, changed, buf_dis, buf_drv,
                          enter_time, list_seq, enter_ll_time, sorted_idx,
                          lc_finished, finish, step, seq_counter,
                          finished_cnt, cum_travel, overflow, interval,
                          max_remove, L, exact):
    """Plain PyTorch version: the JAX package's function, the exact sum as
    an explicit loop, the transfer order as a stable torch.sort, each env
    along its own row."""
    f = buf_dis.dtype
    B, V = running.shape
    dev = running.device
    removed = running & end
    counted = removed
    if lc_finished is not None:
        counted = removed & ~(lc_finished | finish)
    tt = step.to(f) * interval
    tt = tt[:, None] - enter_time
    n_counted = counted.sum(-1, dtype=torch.int32)
    if exact:
        sidx = sorted_idx.long()
        pos = _first_true(counted.gather(-1, sidx), max_remove)
        tt_sorted = tt.gather(-1, sidx)
        vals = torch.where(pos >= 0, tt_sorted.gather(
            -1, pos.clamp(0, max(V - 1, 0)).long()), 0.0)
        total = torch.zeros(B, dtype=f, device=dev)
        for i in range(max_remove):
            total = total + vals[:, i]
        ov = torch.where(n_counted > max_remove, OV_REMOVE, 0)
    else:
        total = torch.sum(torch.where(counted, tt, 0.0), -1)
        ov = torch.zeros(B, dtype=torch.int32, device=dev)
    trans = running & changed & ~removed
    order = torch.sort(torch.where(trans, -buf_dis, torch.inf), dim=-1,
                       stable=True).indices
    rank = torch.empty((B, V), dtype=torch.int32, device=dev).scatter_(
        -1, order, torch.arange(V, dtype=torch.int32,
                                device=dev).expand(B, V))
    return dict(
        removed=removed,
        list_seq=torch.where(trans, seq_counter[:, None] + rank, list_seq),
        enter_ll_time=torch.where(
            trans, torch.where(buf_drv >= L, step[:, None], INT_MAX),
            enter_ll_time),
        finished_cnt=finished_cnt + n_counted,
        cum_travel=cum_travel + total,
        seq_counter=seq_counter + trans.sum(-1, dtype=torch.int32),
        overflow=overflow | ov.to(torch.int32))


def update_location(running, end, changed, buf_dis, buf_drv, enter_time,
                    list_seq, enter_ll_time, sorted_idx, lc_finished, finish,
                    step, seq_counter, finished_cnt, cum_travel, overflow,
                    interval, max_remove, L, exact):
    """G10 on CUDA tensors, the plain version on CPU tensors."""
    args = (running, end, changed, buf_dis, buf_drv, enter_time, list_seq,
            enter_ll_time, sorted_idx, lc_finished, finish, step,
            seq_counter, finished_cnt, cum_travel, overflow, interval)
    cpu = running.device.type == "cpu"
    b8, i32, f = (torch.bool,), (torch.int32,), _lib.FLOATS
    _lib.check_args("update_location", *args,
                    dtypes=[b8, b8, b8, f, i32, f, i32, i32, i32, b8, b8,
                            i32, i32, i32, f, i32, f], cuda=not cpu)
    lead = tuple(running.shape)
    if len(lead) != 2 \
            or any(t is not None and tuple(t.shape) != lead
                   for t in args[:11]) \
            or any(tuple(t.shape) != lead[:-1] for t in args[11:16]) \
            or interval.dim() != 0:
        raise ValueError(f"update_location: per-slot inputs must be {lead}"
                         f" (B, V), the per-env scalars "
                         f"{lead[:-1]} and the interval 0-dim")
    if exact and sorted_idx is None:
        raise ValueError("update_location: exact mode needs sorted_idx")
    if (lc_finished is None) != (finish is None):
        raise ValueError("update_location: lc_finished and finish go "
                         "together")
    if cpu:
        return update_location_plain(*args, max_remove, L, exact)
    return _launch(args, max_remove, L, exact)


def _launch(args, max_remove, L, exact):
    global launches, launches_fast, launches_f32
    running, buf_dis = args[0], args[3]
    B, V = running.shape
    dev = running.device
    fp32 = _lib.fp32("update_location", *args)
    i32 = dict(dtype=torch.int32, device=dev)
    out = dict(removed=torch.empty((B, V), dtype=torch.bool, device=dev),
               list_seq=torch.empty((B, V), **i32),
               enter_ll_time=torch.empty((B, V), **i32),
               finished_cnt=torch.empty(B, **i32),
               cum_travel=torch.empty(B, dtype=buf_dis.dtype, device=dev),
               seq_counter=torch.empty(B, **i32),
               overflow=torch.empty(B, **i32))
    flags = torch.empty((B, 2 * V), dtype=torch.uint8, device=dev)
    iscratch = torch.empty((B, 3 * V + 2), **i32)
    vals = torch.empty((B, max(max_remove, 1)), dtype=buf_dis.dtype,
                       device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    a = _Args(*(ptr(t) for t in args), *(out[k].data_ptr() for k in OUT),
              flags.data_ptr(), iscratch.data_ptr(), vals.data_ptr(),
              B, V, max_remove, L, int(bool(exact)), fp32)
    _lib.check(_lib.lib().update_location(ctypes.byref(a),
                                          _lib.stream_ptr(running)),
               "update_location")
    launches += 1
    launches_fast += int(not exact)
    launches_f32 += fp32
    return out
