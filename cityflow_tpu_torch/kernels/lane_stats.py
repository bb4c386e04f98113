"""O1 lane_stats: per-lane reductions over the occupied slots of the lane
rings (csrc/lane_stats.cu), in three modes:

  lane_waiting   waiting vehicles per lane (speed < 0.1)       (N, B) i32
  lane_history   Lane::updateHistory's rolling window: the lane count and
                 occupied speed sum of this step enter ring row h_t % H
                 (written in place) and the window sums; returns the new
                 (h_num, h_ssum)
  lane_obs       the waiting counts and, per env, the time in flight of
                 every vehicle on a lane or link: the sum of now - enter
                 over occupied lane slots plus the same over link slots

Rings are (S, N, B) with the env axis B last; counts (N, B) int32.
"""

import ctypes

import torch

from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_hist = 0       # of those, in the history mode
launches_obs = 0        # of those, in the observation mode

F32, I32 = torch.float32, torch.int32
WAIT, HIST, OBS = 0, 1, 2


class _Args(ctypes.Structure):
    _fields_ = ([("mode", ctypes.c_int), ("speed", ctypes.c_void_p),
                 ("n", ctypes.c_void_p)]
                + [(k, ctypes.c_longlong) for k in ("S", "N", "B")]
                + [(k, ctypes.c_void_p) for k in (
                    "wait", "ring_num", "ring_ssum", "h_num", "h_ssum",
                    "h_num_out", "h_ssum_out", "h_t")]
                + [("H", ctypes.c_longlong)]
                + [(k, ctypes.c_void_p) for k in ("enter", "k_enter", "n_k")]
                + [(k, ctypes.c_longlong) for k in ("SK", "NK")]
                + [(k, ctypes.c_void_p) for k in ("now", "part",
                                                  "inflight")])


def _occ(S, n):
    return torch.arange(S, device=n.device)[:, None, None] < n[None]


def lane_waiting_plain(speed, n):
    return (_occ(speed.shape[0], n) & (speed < 0.1)).sum(0, dtype=I32)


def lane_history_plain(speed, n, ring_num, ring_ssum, h_num, h_ssum, h_t):
    H, N, B = ring_num.shape
    cur_num = n.to(F32)
    cur_ssum = torch.where(_occ(speed.shape[0], n), speed, 0.0).sum(0)
    idx = (h_t % H).long()[None, None, :].expand(1, N, B)
    full = h_t >= H
    old_num = torch.where(full, ring_num.gather(0, idx)[0], 0.0)
    old_ssum = torch.where(full, ring_ssum.gather(0, idx)[0], 0.0)
    ring_num.scatter_(0, idx, cur_num[None])
    ring_ssum.scatter_(0, idx, cur_ssum[None])
    return (h_num - old_num) + cur_num, (h_ssum - old_ssum) + cur_ssum


def lane_obs_plain(speed, n, enter, k_enter, n_k, now):
    occ = _occ(speed.shape[0], n)
    wait = (occ & (speed < 0.1)).sum(0, dtype=I32)
    lane = torch.where(occ, now - enter, 0.0).sum(0).sum(0)
    link = torch.where(_occ(k_enter.shape[0], n_k), now - k_enter,
                       0.0).sum(0).sum(0)
    return wait, lane + link


def _check_ring(name, ring, n):
    S, N, B = ring.shape
    if tuple(n.shape) != (N, B):
        raise ValueError(f"{name}: counts {tuple(n.shape)} != {(N, B)}")


def _launch(a, like):
    rc = _lib.lib().lane_stats(ctypes.byref(a), _lib.stream_ptr(like))
    _lib.check(rc, "lane_stats")


def lane_waiting(speed, n):
    """O1 waiting mode on CUDA tensors, the plain version on CPU tensors."""
    global launches
    cpu = speed.device.type == "cpu"
    _lib.check_args("lane_stats", speed, n, dtypes=[(F32,), (I32,)],
                    cuda=not cpu)
    _check_ring("lane_stats", speed, n)
    if cpu:
        return lane_waiting_plain(speed, n)
    S, N, B = speed.shape
    wait = torch.empty((N, B), dtype=I32, device=speed.device)
    a = _Args(mode=WAIT, speed=speed.data_ptr(), n=n.data_ptr(), S=S, N=N,
              B=B, wait=wait.data_ptr())
    _launch(a, speed)
    launches += 1
    return wait


def lane_history(speed, n, ring_num, ring_ssum, h_num, h_ssum, h_t):
    """O1 history mode: writes ring row h_t % H of ring_num / ring_ssum
    in place (per env) and returns the new window sums (h_num, h_ssum)."""
    global launches, launches_hist
    cpu = speed.device.type == "cpu"
    _lib.check_args("lane_stats", speed, n, ring_num, ring_ssum, h_num,
                    h_ssum, h_t,
                    dtypes=[(F32,), (I32,), (F32,), (F32,), (F32,), (F32,),
                            (I32,)], cuda=not cpu)
    _check_ring("lane_stats", speed, n)
    S, N, B = speed.shape
    H = ring_num.shape[0]
    for t in (ring_num, ring_ssum):
        if tuple(t.shape) != (H, N, B):
            raise ValueError(f"lane_stats: ring {tuple(t.shape)}")
    for t in (h_num, h_ssum):
        if tuple(t.shape) != (N, B):
            raise ValueError(f"lane_stats: window {tuple(t.shape)}")
    if tuple(h_t.shape) != (B,):
        raise ValueError(f"lane_stats: h_t {tuple(h_t.shape)}")
    if cpu:
        return lane_history_plain(speed, n, ring_num, ring_ssum, h_num,
                                  h_ssum, h_t)
    num_out = torch.empty_like(h_num)
    ssum_out = torch.empty_like(h_ssum)
    a = _Args(mode=HIST, speed=speed.data_ptr(), n=n.data_ptr(), S=S, N=N,
              B=B, ring_num=ring_num.data_ptr(),
              ring_ssum=ring_ssum.data_ptr(), h_num=h_num.data_ptr(),
              h_ssum=h_ssum.data_ptr(), h_num_out=num_out.data_ptr(),
              h_ssum_out=ssum_out.data_ptr(), h_t=h_t.data_ptr(), H=H)
    _launch(a, speed)
    launches += 1
    launches_hist += 1
    return num_out, ssum_out


def lane_obs(speed, n, enter, k_enter, n_k, now):
    """O1 observation mode: (waiting (N, B) int32, in-flight time (B,))."""
    global launches, launches_obs
    cpu = speed.device.type == "cpu"
    _lib.check_args("lane_stats", speed, n, enter, k_enter, n_k, now,
                    dtypes=[(F32,), (I32,), (F32,), (F32,), (I32,), (F32,)],
                    cuda=not cpu)
    _check_ring("lane_stats", speed, n)
    _check_ring("lane_stats", k_enter, n_k)
    S, N, B = speed.shape
    SK, NK = k_enter.shape[:2]
    if tuple(enter.shape) != (S, N, B) or tuple(now.shape) != (B,) \
            or k_enter.shape[2] != B:
        raise ValueError("lane_stats: enter / k_enter / now shapes")
    if cpu:
        return lane_obs_plain(speed, n, enter, k_enter, n_k, now)
    wait = torch.empty((N, B), dtype=I32, device=speed.device)
    part = torch.empty((N + NK, B), dtype=F32, device=speed.device)
    inflight = torch.empty((B,), dtype=F32, device=speed.device)
    a = _Args(mode=OBS, speed=speed.data_ptr(), n=n.data_ptr(), S=S, N=N,
              B=B, wait=wait.data_ptr(), enter=enter.data_ptr(),
              k_enter=k_enter.data_ptr(), n_k=n_k.data_ptr(), SK=SK, NK=NK,
              now=now.data_ptr(), part=part.data_ptr(),
              inflight=inflight.data_ptr())
    _launch(a, speed)
    launches += 1
    launches_obs += 1
    return wait, inflight
