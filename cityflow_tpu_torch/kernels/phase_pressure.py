"""O2 phase_pressure: per intersection and candidate phase, the MaxPressure
pressure and action, or the DQN's per-phase features
(csrc/phase_pressure.cu).

From the waiting counts w (N, B) int32 of the lanes (O1), through the index
tables of compiler/ring_net.index_tables: a link's start lane is
in_src[start_src], its end lane end_src, its roadlink row rl_src. A link
is available in phase ph of intersection g when
phase_rl_avail[clip(g_phase_offset[g] + ph, 0, TP - 1), rl] > 0.5; phase
ph is valid when ph < g_n_phases[g].

  pressures mode: (pressure (G, P, B) f32, -inf where not valid;
                   actions (I, B) i32, the first maximum, 0 for g >= G)
  features mode:  (fw (G, P, B), fp (G, P, B), w_up (G, B)) f32: the
                   waiting on each phase's available start lanes, its
                   pressure (0 where not valid), the start-lane waiting of
                   all links
"""

import ctypes

import torch

from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_features = 0   # of those, in the features mode

MAX_P = 64              # phases per intersection (csrc/phase_pressure.cu)
F32, I32 = torch.float32, torch.int32
TABLES = ("start_src", "in_src", "end_src", "rl_src", "phase_rl_avail",
          "g_phase_offset", "g_n_phases")


class _Args(ctypes.Structure):
    _fields_ = ([("mode", ctypes.c_int)]
                + [(k, ctypes.c_void_p) for k in (
                    "w", "start_src", "in_src", "end_src", "rl_src",
                    "avail", "g_off", "g_nph")]
                + [(k, ctypes.c_longlong) for k in (
                    "G", "I", "LPI", "ILG", "N", "B", "TP", "MAXRL")]
                + [("P", ctypes.c_int)]
                + [(k, ctypes.c_void_p) for k in (
                    "press", "actions", "fw", "fp", "w_up")])


def _take(x, idx):
    """x[idx] along the first axis, 0 where idx < 0 ((J,) index)."""
    got = x[idx.clamp(min=0).long()]
    return torch.where((idx >= 0)[:, None], got, torch.zeros_like(got))


def phase_pressure_plain(w, tabs, P, I, features=False):
    """Plain PyTorch version (JAX ring_observe.phase_pressures /
    phase_features / max_pressure_phases_ring on the trailing-batch
    layout)."""
    N, B = w.shape
    G = tabs["g_n_phases"].shape[0]
    wf = w.to(F32)
    w_in = _take(wf, tabs["in_src"].reshape(-1))
    w_start = _take(w_in, tabs["start_src"])                # (LPI * G, B)
    w_end = _take(wf, tabs["end_src"])
    diff = w_start - w_end
    LPI = w_start.shape[0] // max(G, 1)
    rl = tabs["rl_src"]
    pra = tabs["phase_rl_avail"]
    TP = pra.shape[0]
    rl_row, rl_col = (rl.clamp(min=0) // G).long(), (rl.clamp(min=0) % G)
    g_off = tabs["g_phase_offset"][rl_col.long()]
    fw, fp, press = [], [], []
    for ph in range(P):
        row = (g_off + ph).clamp(0, TP - 1).long()
        av = ((rl >= 0) & (pra[row, rl_row] > 0.5))[:, None]
        valid = (ph < tabs["g_n_phases"])[:, None]
        s_w = torch.where(av, w_start, 0.0).reshape(LPI, G, B).sum(0)
        s_p = torch.where(av, diff, 0.0).reshape(LPI, G, B).sum(0)
        fw.append(torch.where(valid, s_w, 0.0))
        fp.append(torch.where(valid, s_p, 0.0))
        press.append(torch.where(valid, s_p, -torch.inf))
    if features:
        return (torch.stack(fw, 1), torch.stack(fp, 1),
                w_start.reshape(LPI, G, B).sum(0))
    press = torch.stack(press, 1)                             # (G, P, B)
    actions = torch.zeros((I, B), dtype=I32, device=w.device)
    actions[:G] = torch.argmax(press, dim=1).to(I32)
    return press, actions


def phase_pressure(w, tabs, P, I, features=False):
    """O2 on CUDA tensors, the plain version on CPU tensors. w (N, B)
    int32 waiting counts; tabs holds TABLES; P phases per intersection
    (max_phases), I intersections (the trailing I - G are virtual)."""
    global launches, launches_features
    cpu = w.device.type == "cpu"
    t = [tabs[k] for k in TABLES]
    _lib.check_args("phase_pressure", w, *t,
                    dtypes=[(I32,)] * 5 + [(F32,), (I32,), (I32,)],
                    cuda=not cpu)
    N, B = w.shape
    G = tabs["g_n_phases"].shape[0]
    if not 1 <= P <= MAX_P:
        raise ValueError(f"phase_pressure: {P} phases (1..{MAX_P})")
    if I < G:
        raise ValueError(f"phase_pressure: I={I} < G={G}")
    if cpu:
        return phase_pressure_plain(w, tabs, P, I, features)
    TP, MAXRL = tabs["phase_rl_avail"].shape
    dev = w.device
    kw = dict(w=w.data_ptr(), start_src=tabs["start_src"].data_ptr(),
              in_src=tabs["in_src"].data_ptr(),
              end_src=tabs["end_src"].data_ptr(),
              rl_src=tabs["rl_src"].data_ptr(),
              avail=tabs["phase_rl_avail"].data_ptr(),
              g_off=tabs["g_phase_offset"].data_ptr(),
              g_nph=tabs["g_n_phases"].data_ptr(), G=G, I=I,
              LPI=tabs["start_src"].shape[0] // max(G, 1),
              ILG=tabs["in_src"].numel(), N=N, B=B, TP=TP, MAXRL=MAXRL, P=P)
    if features:
        fw = torch.empty((G, P, B), dtype=F32, device=dev)
        fp = torch.empty((G, P, B), dtype=F32, device=dev)
        w_up = torch.empty((G, B), dtype=F32, device=dev)
        a = _Args(mode=1, fw=fw.data_ptr(), fp=fp.data_ptr(),
                  w_up=w_up.data_ptr(), **kw)
        out = (fw, fp, w_up)
    else:
        press = torch.empty((G, P, B), dtype=F32, device=dev)
        actions = torch.empty((I, B), dtype=I32, device=dev)
        a = _Args(mode=0, press=press.data_ptr(),
                  actions=actions.data_ptr(), **kw)
        out = (press, actions)
    rc = _lib.lib().phase_pressure(ctypes.byref(a), _lib.stream_ptr(w))
    _lib.check(rc, "phase_pressure")
    launches += 1
    launches_features += int(features)
    return out
