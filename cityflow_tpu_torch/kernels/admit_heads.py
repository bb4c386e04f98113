"""G12 admit_heads: Engine::handleWaiting's admission (engine.cpp:502-516,
Lane::available roadnet.cpp:428-436) up to the leader scan, for B envs at
once (one env is B = 1; csrc/admit_heads.cu).

Per lane of each env: the FIFO head of the waiting vehicles (the least
uid among the active, not running vehicles that hold the lane in drv),
whether the lane takes it (no rear vehicle at the end of the previous
step, or that vehicle's dis > len + the head's minGap), and the admission:
the head starts running with list ticket seq_counter, and behind the rear
vehicle its leader is that vehicle and its gap (dis - len) - its own dis.

Inputs, (B, V) per slot (params (B, V, 12)): active, running (bool), drv,
uid, leader, list_seq (i32), dis, gap, params (float); last_of (B, D) i32,
the rear vehicle per drivable at the end of the previous step; seq_counter
(B,); L lanes. Returns running,
leader, gap, list_seq (the new per-slot values), need_scan (bool: admitted
with no rear vehicle ahead, so its leader comes from the scan) and head
(B, L) i32: each lane's head slot, -1 for none.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.state import INT_MAX
from cityflow_tpu_torch.core.step import P_LEN, P_MINGAP, egat
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_f32 = 0       # float32 (fast-mode) launches among them
SLOTS = ("active", "running", "drv", "uid", "dis", "params", "leader", "gap",
         "list_seq")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        SLOTS + ("last_of", "seq_counter", "keys", "head", "running_out",
                 "leader_out", "gap_out", "list_seq_out", "need_scan"))]
        + [(n, ctypes.c_longlong) for n in ("B", "V", "D", "L", "NP",
                                            "fp32")])


def admit_heads_plain(active, running, drv, uid, dis, params, leader, gap,
                      list_seq, last_of, seq_counter, L):
    """Plain PyTorch version: the JAX package's admit_waiting up to the
    leader scan (scatter-min of uid per lane, then of the head slot, the
    lane pack read back with one gather), each env along its own axis."""
    B, V = active.shape
    dev = dis.device
    waiting = active & ~running
    lane = drv                  # waiting vehicles hold their first lane
    seq = torch.where(waiting, uid, INT_MAX)
    lane_safe = torch.where(waiting, lane, L).long()
    min_seq = torch.full((B, L + 1), INT_MAX, dtype=torch.int32,
                         device=dev).scatter_reduce(-1, lane_safe, seq,
                                                    "amin")[:, :L]
    is_head = waiting & (uid == egat(min_seq, lane))
    slots = torch.arange(V, dtype=torch.int32, device=dev).expand(B, V)
    head = torch.full((B, L + 1), V, dtype=torch.int32,
                      device=dev).scatter_reduce(
        -1, torch.where(is_head, lane, L).long(), slots, "amin")[:, :L]
    head = torch.where(head < V, head, -1)
    head_mingap = egat(params[..., P_MINGAP], head)

    tail_l = last_of[:, :L]
    tla = egat(torch.stack([dis, params[..., P_LEN]], dim=-1), tail_l)
    has_tail_l = tail_l >= 0
    avail_l = ~has_tail_l | (tla[..., 0] > tla[..., 1] + head_mingap)
    f = dis.dtype
    lane_pack = torch.stack([
        avail_l.to(f), has_tail_l.to(f), tail_l.to(f),
        tla[..., 0] - tla[..., 1]], dim=-1)

    lp = egat(lane_pack, lane)
    admit = is_head & (lp[..., 0] > 0)
    has_tail = lp[..., 1] > 0
    tail = lp[..., 2].to(torch.int32)
    # updateLeaderAndGap(tail): gap = tail.dis - tail.len - 0
    # (vehicle.cpp:158-160)
    return dict(
        running=running | admit,
        leader=torch.where(admit & has_tail, tail, leader),
        gap=torch.where(admit & has_tail, lp[..., 3] - dis, gap),
        list_seq=torch.where(admit, seq_counter[:, None], list_seq),
        need_scan=admit & ~has_tail,
        head=head.contiguous())


def admit_heads(active, running, drv, uid, dis, params, leader, gap,
                list_seq, last_of, seq_counter, L):
    """G12 on CUDA tensors, the plain version on CPU tensors."""
    ins = (active, running, drv, uid, dis, params, leader, gap, list_seq,
           last_of, seq_counter)
    cpu = active.device.type == "cpu"
    b8, i32, f = (torch.bool,), (torch.int32,), _lib.FLOATS
    _lib.check_args("admit_heads", *ins,
                    dtypes=[b8, b8, i32, i32, f, f, i32, f, i32, i32, i32],
                    cuda=not cpu)
    lead = tuple(active.shape)
    if len(lead) != 2 \
            or any(tuple(t.shape) != lead
                   for t in ins[:9] if t is not params) \
            or tuple(params.shape[:-1]) != lead \
            or tuple(last_of.shape[:-1]) != lead[:-1] \
            or tuple(seq_counter.shape) != lead[:-1]:
        raise ValueError("admit_heads: per-slot inputs must be (B, V), "
                         "last_of and seq_counter with their env axis")
    if cpu:
        return admit_heads_plain(*ins, L)
    return _launch(ins, L)


def _launch(ins, L):
    global launches, launches_f32
    active, dis, params, last_of = ins[0], ins[4], ins[5], ins[9]
    B, V = active.shape
    dev = active.device
    i32 = dict(dtype=torch.int32, device=dev)
    # per lane the 64-bit keys (uid, least slot) and, where the uid
    # repeats, (uid, ~greatest slot)
    keys = torch.empty((B, L, 2), dtype=torch.int64, device=dev)
    out = dict(running=torch.empty((B, V), dtype=torch.bool, device=dev),
               leader=torch.empty((B, V), **i32),
               gap=torch.empty((B, V), dtype=dis.dtype, device=dev),
               list_seq=torch.empty((B, V), **i32),
               need_scan=torch.empty((B, V), dtype=torch.bool, device=dev),
               head=torch.empty((B, L), **i32))
    fp32 = _lib.fp32("admit_heads", dis, params, ins[7])
    a = _Args(*(t.data_ptr() for t in ins), keys.data_ptr(),
              out["head"].data_ptr(), out["running"].data_ptr(),
              out["leader"].data_ptr(), out["gap"].data_ptr(),
              out["list_seq"].data_ptr(), out["need_scan"].data_ptr(),
              B, V, last_of.shape[-1], L, params.shape[-1], fp32)
    _lib.check(_lib.lib().admit_heads(ctypes.byref(a), _lib.stream_ptr(dis)),
               "admit_heads")
    launches += 1
    launches_f32 += fp32
    return out
