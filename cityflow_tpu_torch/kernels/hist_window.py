"""G5 hist_window: the gen-1 DURATION router's lane-history window
(csrc/hist_window.cu), Lane::updateHistory for every lane of B envs at
once (one env is B = 1).

Inputs: G1's last_of (B, D) and leader (B, V) (i32) of the arrangement the
call belongs to, speed (B, V) f64, the ring rows ring_num / ring_ssum
(B, HL1, L) f64, the window sums hist_num / hist_ssum (B, L) f64 and
hist_t (B,) i32 (each env's calls so far); float32 for f64 in fast mode.
Returns (hist_num, hist_ssum, ring_num, ring_ssum): each env's per-lane
vehicle count and speed sum of this call go into its ring row hist_t %
HL1 (its own hist_t: envs need not step in lockstep), and each window sum
becomes sum - old row + this call's (the old row counts once the ring is
full). With inplace=False (the caller keeps its state) they are new
tensors, the rings copies whose one row is written; with inplace=True
(the caller donates its state) the four inputs themselves, written in
place: each env's one ring row and its sums, nothing else (the four must
not overlap in memory). The in-place launches count apart as
hist_window@inplace.

Each lane's vehicles are summed in one fixed order: G1's per-drivable
order walked from the rear along the leader chain. The JAX package adds
them by scatter-add in an order XLA chooses, so the counts are equal and
the speed sums equal up to the order of the adds.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import egat
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_f32 = 0       # float32 (fast-mode) launches among them
launches_inplace = 0   # in-place launches among them


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "last_of", "leader", "speed", "ring_num", "ring_ssum", "hist_num",
        "hist_ssum", "hist_t", "out_num", "out_ssum", "ring_num_out",
        "ring_ssum_out")]
        + [(n, ctypes.c_longlong) for n in ("B", "L", "D", "HL1", "V",
                                            "fp32")])


def lane_sums_plain(last_of, leader, speed, L):
    """Per env and lane (count, speed sum) of its running vehicles, added
    one vehicle at a time from the rear along the leader chain."""
    cur = last_of[:, :L]
    n = torch.zeros(cur.shape, dtype=speed.dtype, device=speed.device)
    s = torch.zeros_like(n)
    while bool((cur >= 0).any()):
        has = cur >= 0
        n = torch.where(has, n + 1, n)
        s = torch.where(has, s + egat(speed, cur), s)
        cur = torch.where(has, egat(leader, cur), -1)
    return n, s


def hist_window_plain(last_of, leader, speed, ring_num, ring_ssum, hist_num,
                      hist_ssum, hist_t, inplace=False):
    """Plain PyTorch version: the lane walk vectorised over envs and
    lanes, then JAX's window update (sum - old + cur) and each env's ring
    row swap (in place: sub_ / add_ in the same order, scatter_)."""
    B, HL1, L = ring_num.shape
    cur_n, cur_s = lane_sums_plain(last_of, leader, speed, L)
    row = (hist_t % HL1).long().view(B, 1, 1).expand(B, 1, L)
    full = (hist_t >= HL1)[:, None]
    old_n = torch.where(full, ring_num.gather(1, row)[:, 0], 0.0)
    old_s = torch.where(full, ring_ssum.gather(1, row)[:, 0], 0.0)
    if not inplace:
        return (hist_num - old_n + cur_n, hist_ssum - old_s + cur_s,
                ring_num.scatter(1, row, cur_n[:, None]),
                ring_ssum.scatter(1, row, cur_s[:, None]))
    hist_num.sub_(old_n).add_(cur_n)
    hist_ssum.sub_(old_s).add_(cur_s)
    ring_num.scatter_(1, row, cur_n[:, None])
    ring_ssum.scatter_(1, row, cur_s[:, None])
    return hist_num, hist_ssum, ring_num, ring_ssum


def hist_window(last_of, leader, speed, ring_num, ring_ssum, hist_num,
                hist_ssum, hist_t, inplace=False):
    """G5 on CUDA tensors, the plain version on CPU tensors."""
    cpu = speed.device.type == "cpu"
    i32, f64 = (torch.int32,), _lib.FLOATS
    _lib.check_args("hist_window", last_of, leader, speed, ring_num,
                    ring_ssum, hist_num, hist_ssum, hist_t,
                    dtypes=[i32, i32, f64, f64, f64, f64, f64, i32],
                    cuda=not cpu)
    if ring_num.dim() != 3 or speed.dim() != 2 or last_of.dim() != 2:
        raise ValueError("hist_window: rings must be (B, HL1, L), slots "
                         "(B, V), last_of (B, D)")
    B, HL1, L = ring_num.shape
    V = speed.shape[1]
    if tuple(ring_ssum.shape) != (B, HL1, L) \
            or tuple(hist_num.shape) != (B, L) \
            or tuple(hist_ssum.shape) != (B, L) \
            or tuple(hist_t.shape) != (B,) \
            or tuple(leader.shape) != (B, V) or speed.shape[0] != B \
            or last_of.shape[0] != B or last_of.shape[1] < L:
        raise ValueError("hist_window: shapes do not fit (B, HL1, L) rings, "
                         "(B, L) sums, (B, V) slots and a (B,) hist_t")
    if inplace:
        _lib.check_disjoint("hist_window", (
            ring_num, ring_ssum, hist_num, hist_ssum, last_of, leader, speed,
            hist_t))
    if cpu:
        return hist_window_plain(last_of, leader, speed, ring_num,
                                 ring_ssum, hist_num, hist_ssum, hist_t,
                                 inplace)
    return _launch(last_of, leader, speed, ring_num, ring_ssum, hist_num,
                   hist_ssum, hist_t, inplace)


def _launch(last_of, leader, speed, ring_num, ring_ssum, hist_num,
            hist_ssum, hist_t, inplace):
    global launches, launches_f32, launches_inplace
    fp32 = _lib.fp32("hist_window", speed, ring_num, ring_ssum, hist_num,
                     hist_ssum)
    B, HL1, L = ring_num.shape
    if inplace:
        # each thread reads its (env, lane)'s old row and sums before it
        # writes the new ones at the same addresses
        out = (hist_num, hist_ssum, ring_num, ring_ssum)
    else:
        # new sums, and new rings: copies whose row hist_t % HL1 the
        # kernel overwrites
        out = (torch.empty_like(hist_num), torch.empty_like(hist_ssum),
               ring_num.clone(), ring_ssum.clone())
    a = _Args(*(t.data_ptr() for t in (
        last_of, leader, speed, ring_num, ring_ssum, hist_num, hist_ssum,
        hist_t, *out)),
        B, L, last_of.shape[1], HL1, speed.shape[1], fp32)
    _lib.check(_lib.lib().hist_window(ctypes.byref(a),
                                      _lib.stream_ptr(speed)),
               "hist_window")
    launches += 1
    launches_f32 += fp32
    launches_inplace += inplace
    return out
