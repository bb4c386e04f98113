"""G14 phase_scores: the gen-1 per-intersection pressures and the
MaxPressure controller, and the DQN's per-phase features
(csrc/phase_scores.cu), for B envs at once (one env is B = 1).

From w (B, L) i32, each lane's waiting vehicles (G13), over the
lanelinks of the net (`net`: ll_start, ll_end, ll_inter, ll_rl_local,
n_phases, phase_offset, phase_rl_avail), in one of three modes:

  "pressure"  (B, I) f32: per intersection the sum over its lanelinks of
              start-lane minus end-lane waiting (core/observe.py
              intersection_pressure)
  "phases"    ((B, TP) f32, (B, I) i32): per (intersection, phase) row the
              pressure summed over the phase's available lanelinks, and per
              intersection the first phase of strictly largest pressure
              among its n phases, from -inf (rl/policies.py
              phase_pressures, max_pressure_phases); P = max_phases
  "features"  ((B, I, P) f32, (B, I, P) f32, (B, I) f32): per intersection and
              phase the waiting on the phase's available upstream lanes
              (fw) and the phase's pressure (fp), 0 for a phase it does not
              have, and the upstream waiting over all its lanelinks (the
              DQN's reward term; rl/dqn.py build_intersection_obs, :143-150)

Every output is a sum of small integers held in float32: exact in any
order while every partial sum stays below 2^24 in magnitude (lanes hold a
few hundred vehicles at most, so the sums stay far below it). The kernel
adds with float atomics, the plain version in JAX's order, and the two are
equal bit for bit under that bound.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import gat
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_phases = 0       # mode "phases" among them
launches_features = 0     # mode "features" among them
MODES = ("pressure", "phases", "features")
TABLES = ("ll_start", "ll_end", "ll_inter", "ll_rl_local", "n_phases",
          "phase_offset", "phase_rl_avail")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        ("w",) + TABLES + ("out0", "out1", "out2"))]
        + [(n, ctypes.c_longlong) for n in ("B", "L", "LL", "I", "TP", "MRL",
                                            "P", "mode")])


def _avail(net, p, n_ph, base):
    """Phase p's availability of each lanelink (jnp.take of a clipped
    index into the flat table) and whether the intersection has p."""
    flat = net["phase_rl_avail"].reshape(-1)
    MRL = net["phase_rl_avail"].shape[1]
    return (p < n_ph) & gat(flat, (base + p) * MRL + net["ll_rl_local"])


def phase_scores_plain(w, net, P, mode):
    """Plain PyTorch version: the JAX package's scatter-adds, each env
    along its own row (P = max_phases)."""
    B = w.shape[0]
    dev = w.device
    f32 = torch.float32
    wf = w.to(f32)
    inter = net["ll_inter"].long()
    I = net["phase_offset"].shape[0]
    win = wf.index_select(-1, net["ll_start"])           # (B, LL)
    press = win - wf.index_select(-1, net["ll_end"])
    if mode == "pressure":
        return torch.zeros((B, I), dtype=f32, device=dev).index_add_(
            -1, inter, press)
    n_ph = gat(net["n_phases"], inter)
    base = gat(net["phase_offset"], inter)
    if mode == "phases":
        TP = net["phase_time"].shape[0]
        tp = torch.zeros((B, TP + 1), dtype=f32, device=dev)
        for p in range(P):
            ok = p < n_ph
            contrib = torch.where(_avail(net, p, n_ph, base), press, 0.0)
            tp.index_add_(-1, torch.where(ok, base + p, TP).long(), contrib)
        tp = tp[:, :TP].contiguous()
        n = net["n_phases"]
        best = torch.zeros((B, I), dtype=torch.int32, device=dev)
        best_v = torch.full((B, I), -torch.inf, dtype=f32, device=dev)
        for p in range(P):
            v = gat(tp.T, net["phase_offset"] + p).T   # clipped row
            better = (p < n) & (v > best_v)
            best = torch.where(better, p, best)
            best_v = torch.where(better, v, best_v)
        return tp, best
    if mode != "features":
        raise ValueError(f"phase_scores: unknown mode {mode!r}")
    fw = torch.zeros((B, I * P), dtype=f32, device=dev)
    fp = torch.zeros((B, I * P), dtype=f32, device=dev)
    for p in range(P):
        m = _avail(net, p, n_ph, base)
        fw.index_add_(-1, inter * P + p, torch.where(m, win, 0.0))
        fp.index_add_(-1, inter * P + p, torch.where(m, press, 0.0))
    up = torch.zeros((B, I), dtype=f32, device=dev).index_add_(-1, inter,
                                                               win)
    return fw.view(B, I, P), fp.view(B, I, P), up


def phase_scores(w, net, max_phases, mode):
    """G14 on CUDA tensors, the plain version on CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"phase_scores: unknown mode {mode!r}")
    cpu = w.device.type == "cpu"
    tabs = [net[k] for k in TABLES]
    i32, b8 = (torch.int32,), (torch.bool,)
    _lib.check_args("phase_scores", w, *tabs,
                    dtypes=[i32] * 7 + [b8], cuda=not cpu)
    if w.dim() != 2:
        raise ValueError("phase_scores: w must be (B, L)")
    if cpu:
        return phase_scores_plain(w, net, max_phases, mode)
    return _launch(w, tabs, net["phase_time"].shape[0], max_phases, mode)


def _launch(w, tabs, TP, P, mode):
    global launches, launches_phases, launches_features
    B, L = w.shape
    LL = tabs[0].shape[0]
    I = tabs[5].shape[0]
    MRL = tabs[6].shape[1]
    dev = w.device
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    if mode == "pressure":
        outs = (z(B, I),)
    elif mode == "phases":
        outs = (z(B, TP), torch.empty((B, I), dtype=torch.int32, device=dev))
    else:
        outs = (z(B, I, P), z(B, I, P), z(B, I))
    ptrs = [t.data_ptr() for t in outs] + [0] * (3 - len(outs))
    a = _Args(w.data_ptr(), *(t.data_ptr() for t in tabs), *ptrs,
              B, L, LL, I, TP, MRL, P, MODES.index(mode))
    _lib.check(_lib.lib().phase_scores(ctypes.byref(a), _lib.stream_ptr(w)),
               "phase_scores")
    launches += 1
    launches_phases += mode == "phases"
    launches_features += mode == "features"
    return outs[0] if mode == "pressure" else outs
