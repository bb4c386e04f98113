"""G5 hist_window: the gen-1 DURATION router's lane-history window
(csrc/hist_window.cu), Lane::updateHistory for every lane.

Inputs: G1's last_of (D,) and leader (V,) (i32) of the arrangement the
call belongs to, speed (V,) f64, the ring rows ring_num / ring_ssum
(HL1, L) f64, the window sums hist_num / hist_ssum (L,) f64 and hist_t
(0-dim i32, the calls so far); float32 for f64 in fast mode. Returns
(hist_num, hist_ssum, ring_num, ring_ssum), new tensors: this call's
per-lane vehicle count and speed sum go into ring row hist_t % HL1, and
each window sum becomes sum - old row + this call's (the old row counts
once the ring is full).

Each lane's vehicles are summed in one fixed order: G1's per-drivable
order walked from the rear along the leader chain. The JAX package adds
them by scatter-add in an order XLA chooses, so the counts are equal and
the speed sums equal up to the order of the adds.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import gat
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_f32 = 0       # float32 (fast-mode) launches among them


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "last_of", "leader", "speed", "ring_num", "ring_ssum", "hist_num",
        "hist_ssum", "hist_t", "out_num", "out_ssum", "ring_num_out",
        "ring_ssum_out")]
        + [(n, ctypes.c_longlong) for n in ("L", "HL1", "V", "fp32")])


def lane_sums_plain(last_of, leader, speed, L):
    """Per lane (count, speed sum) of its running vehicles, added one
    vehicle at a time from the rear along the leader chain."""
    cur = last_of[:L]
    n = torch.zeros(L, dtype=speed.dtype, device=speed.device)
    s = torch.zeros_like(n)
    while bool((cur >= 0).any()):
        has = cur >= 0
        n = torch.where(has, n + 1, n)
        s = torch.where(has, s + gat(speed, cur), s)
        cur = torch.where(has, gat(leader, cur), -1)
    return n, s


def hist_window_plain(last_of, leader, speed, ring_num, ring_ssum, hist_num,
                      hist_ssum, hist_t):
    """Plain PyTorch version: the lane walk vectorised over lanes, then
    JAX's window update (sum - old + cur) and the ring row swap."""
    HL1, L = ring_num.shape
    cur_n, cur_s = lane_sums_plain(last_of, leader, speed, L)
    slot = (hist_t % HL1).reshape(1).long()
    full = hist_t >= HL1
    old_n = torch.where(full, ring_num.index_select(0, slot)[0], 0.0)
    old_s = torch.where(full, ring_ssum.index_select(0, slot)[0], 0.0)
    return (hist_num - old_n + cur_n, hist_ssum - old_s + cur_s,
            ring_num.index_copy(0, slot, cur_n[None]),
            ring_ssum.index_copy(0, slot, cur_s[None]))


def hist_window(last_of, leader, speed, ring_num, ring_ssum, hist_num,
                hist_ssum, hist_t):
    """G5 on CUDA tensors, the plain version on CPU tensors."""
    cpu = speed.device.type == "cpu"
    i32, f64 = (torch.int32,), _lib.FLOATS
    _lib.check_args("hist_window", last_of, leader, speed, ring_num,
                    ring_ssum, hist_num, hist_ssum, hist_t,
                    dtypes=[i32, i32, f64, f64, f64, f64, f64, i32],
                    cuda=not cpu)
    HL1, L = ring_num.shape
    V = speed.shape[0]
    if tuple(ring_ssum.shape) != (HL1, L) or tuple(hist_num.shape) != (L,) \
            or tuple(hist_ssum.shape) != (L,) or hist_t.dim() != 0 \
            or leader.shape[0] != V or last_of.shape[0] < L:
        raise ValueError("hist_window: shapes do not fit (HL1, L) rings, "
                         "(L,) sums, (V,) slots and a 0-dim hist_t")
    if cpu:
        return hist_window_plain(last_of, leader, speed, ring_num,
                                 ring_ssum, hist_num, hist_ssum, hist_t)
    return _launch(last_of, leader, speed, ring_num, ring_ssum, hist_num,
                   hist_ssum, hist_t)


def _launch(last_of, leader, speed, ring_num, ring_ssum, hist_num,
            hist_ssum, hist_t):
    global launches, launches_f32
    fp32 = _lib.fp32("hist_window", speed, ring_num, ring_ssum, hist_num,
                     hist_ssum)
    HL1, L = ring_num.shape
    out_num = torch.empty_like(hist_num)
    out_ssum = torch.empty_like(hist_ssum)
    ring_num_out = ring_num.clone()
    ring_ssum_out = ring_ssum.clone()
    a = _Args(*(t.data_ptr() for t in (
        last_of, leader, speed, ring_num, ring_ssum, hist_num, hist_ssum,
        hist_t, out_num, out_ssum, ring_num_out, ring_ssum_out)),
        L, HL1, speed.shape[0], fp32)
    _lib.check(_lib.lib().hist_window(ctypes.byref(a),
                                      _lib.stream_ptr(speed)),
               "hist_window")
    launches += 1
    launches_f32 += fp32
    return out_num, out_ssum, ring_num_out, ring_ssum_out
