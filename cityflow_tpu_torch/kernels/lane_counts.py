"""G13 lane_counts: the gen-1 observations' per-lane and per-env
reductions over the slot pool (csrc/lane_counts.cu), the JAX package's
core/observe.py lane_vehicle_count, lane_waiting_vehicle_count,
drivable_vehicle_count and _avg_travel_time's sums, for B envs at once
(one env is B = 1).

Inputs (B, V) per slot: running, active (bool), drv (i32), speed,
enter_time (float); step (B,) i32; interval
(0-dim, enter_time's dtype), or None to skip the per-env sums; L lanes; D
drivables, or None to skip the per-drivable counts. Returns, with the
inputs' env axis:

  lane_count      (B, L) i32 running vehicles on each lane
  lane_waiting    (B, L) i32 those with speed < 0.1 (engine.cpp:641)
  drivable_count  (B, D) i32 running vehicles on each drivable (None
                  without D)
  running, active (B,) i32 vehicle counts (None without interval)
  inflight        (B,) float: the sum over active vehicles of
                  step * interval - enter_time (None without interval)

The counts are exact in any order (integer atomics on the card). The
in-flight sum is a float sum: the kernel adds in a fixed tree order of its
own, the plain version in torch.sum's, so the two agree within float
rounding (1e-5 relative in float32), not bit for bit.
"""

import ctypes

import torch

from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_drivables = 0    # the calls with the per-drivable counts


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "running", "active", "drv", "speed", "enter_time", "step",
        "interval", "lane_count", "lane_waiting", "drv_count", "n_running",
        "n_active", "inflight")]
        + [(n, ctypes.c_longlong) for n in ("B", "V", "L", "D", "fp32")])


def lane_counts_plain(running, active, drv, speed, enter_time, step,
                      interval, L, D=None):
    """Plain PyTorch version: JAX's drop-row scatter-adds and sums, each env
    along its own row."""
    B = running.shape[0]
    dev = running.device

    def count(mask, n):
        idx = torch.where(mask, drv, n).long()
        out = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
        ones = torch.ones_like(idx, dtype=torch.int32)
        return out.scatter_add_(-1, idx, ones)[:, :n].contiguous()
    on_lane = running & (drv >= 0) & (drv < L)
    out = dict(
        lane_count=count(on_lane, L),
        lane_waiting=count(on_lane & (speed < 0.1), L),
        drivable_count=(None if D is None
                        else count(running & (drv >= 0), D)),
        running=None, active=None, inflight=None)
    if interval is not None:
        now = step.to(enter_time.dtype) * interval
        out.update(
            running=running.sum(-1, dtype=torch.int32),
            active=active.sum(-1, dtype=torch.int32),
            inflight=torch.where(active, now[:, None] - enter_time,
                                 0.0).sum(-1))
    return out


def lane_counts(running, active, drv, speed, enter_time, step, interval, L,
                D=None):
    """G13 on CUDA tensors, the plain version on CPU tensors."""
    ins = (running, active, drv, speed, enter_time, step, interval)
    cpu = running.device.type == "cpu"
    b8, i32, f = (torch.bool,), (torch.int32,), _lib.FLOATS
    _lib.check_args("lane_counts", *ins, dtypes=[b8, b8, i32, f, f, i32, f],
                    cuda=not cpu)
    lead = tuple(running.shape)
    if len(lead) != 2 \
            or any(tuple(t.shape) != lead for t in ins[1:5]) \
            or tuple(step.shape) != lead[:-1] \
            or (interval is not None and interval.dim() != 0):
        raise ValueError("lane_counts: per-slot inputs (B, V), step (B,), "
                         "interval 0-dim or None")
    if cpu:
        return lane_counts_plain(*ins, L, D)
    return _launch(ins, L, D)


def _launch(ins, L, D):
    global launches, launches_drivables
    running, enter_time = ins[0], ins[4]
    B, V = running.shape
    dev = running.device
    nd = 0 if D is None else D
    buf = torch.zeros(B * (2 * L + nd), dtype=torch.int32, device=dev)
    lane_count = buf[:B * L].view(B, L)
    lane_waiting = buf[B * L:2 * B * L].view(B, L)
    drv_count = buf[2 * B * L:].view(B, nd) if D is not None else None
    i32 = dict(dtype=torch.int32, device=dev)
    sums = ins[6] is not None
    out = dict(lane_count=lane_count, lane_waiting=lane_waiting,
               drivable_count=drv_count,
               running=torch.empty(B, **i32) if sums else None,
               active=torch.empty(B, **i32) if sums else None,
               inflight=torch.empty(B, dtype=enter_time.dtype, device=dev)
               if sums else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    a = _Args(*(ptr(t) for t in ins), *(ptr(out[k]) for k in (
        "lane_count", "lane_waiting", "drivable_count", "running", "active",
        "inflight")), B, V, L, nd,
        _lib.fp32("lane_counts", ins[3], enter_time, ins[6]))
    _lib.check(_lib.lib().lane_counts(ctypes.byref(a),
                                      _lib.stream_ptr(running)),
               "lane_counts")
    launches += 1
    launches_drivables += D is not None
    return out
