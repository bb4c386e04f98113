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

The kernel reads none of those tables: the wrapper derives from them,
once per net, each intersection's distinct lanes and per lane the counts
of its links that start there, that start there and are available in
each phase, and that less those that end there (lane_tables, kept in the
tables' dict); the kernel sums each lane's waiting count times its
counts, a thread per (intersection, env).
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
LANES, COEF = "o2_lanes", "o2_coef"   # the kernel's tables in `tabs`
CW, CS, CP = 136, 8, 72  # a lane's int16 counts: cup, cs[ph], cp[ph]


class _Args(ctypes.Structure):
    _fields_ = ([("mode", ctypes.c_int)]
                + [(k, ctypes.c_void_p) for k in ("w", "lanes", "coef",
                                                  "g_nph")]
                + [(k, ctypes.c_longlong) for k in ("G", "I", "E", "N",
                                                    "B")]
                + [("P", ctypes.c_int)]
                + [(k, ctypes.c_void_p) for k in (
                    "press", "actions", "fw", "fp", "w_up")])


def _link_lanes(tabs):
    """Per link row l * G + g: its start lane (in_src[start_src], -1 for
    none), its end lane (end_src) and (MAX_P, LPI * G) bool, the link
    available in phase ph: phase_rl_avail[clip(g_phase_offset[col] + ph,
    0, TP - 1), rl] > 0.5 for rl_src = rl * G + col (never for -1)."""
    G = tabs["g_n_phases"].shape[0]
    ss, ins = tabs["start_src"], tabs["in_src"].reshape(-1)
    ILG = ins.numel()
    ok = (ss >= 0) & (ss < ILG)
    start = torch.where(ok, ins[ss.clamp(0, max(ILG - 1, 0)).long()], -1) \
        if ILG else torch.full_like(ss, -1)
    rl = tabs["rl_src"]
    pra = tabs["phase_rl_avail"]
    TP = pra.shape[0]
    rl_row = (rl.clamp(min=0) // G).long()
    rl_col = (rl.clamp(min=0) % G).long()
    ph = torch.arange(MAX_P, device=rl.device)[:, None]
    row = (tabs["g_phase_offset"][rl_col][None] + ph).clamp(0, TP - 1)
    av = (rl >= 0)[None] & (pra[row.long(), rl_row[None]] > 0.5)
    return start.long(), tabs["end_src"].long(), av


def _build(tabs):
    G = tabs["g_n_phases"].shape[0]
    dev = tabs["start_src"].device
    if G == 0:
        return (torch.zeros((0, 1), dtype=I32, device=dev),
                torch.zeros((0, 1, CW), dtype=torch.int16, device=dev))
    start, end, av = _link_lanes(tabs)
    LPI = start.shape[0] // G
    if LPI >= 2 ** 15:
        raise ValueError(f"phase_pressure: {LPI} links an intersection")
    g_of = torch.arange(start.shape[0], device=dev) % G
    N1 = int(torch.cat([start, end]).max().clamp(min=0)) + 1
    key = lambda lane: g_of * N1 + lane
    vs, ve = start >= 0, end >= 0
    uk = torch.unique(torch.cat([key(start)[vs], key(end)[ve]]))
    ug, ul = uk // N1, uk % N1
    cnt = torch.bincount(ug, minlength=G)
    E = max(int(cnt.max()) if uk.numel() else 0, 1)
    pos = torch.arange(uk.numel(), device=dev) - (cnt.cumsum(0) - cnt)[ug]
    lanes = torch.full((G, E), -1, dtype=I32, device=dev)
    lanes[ug, pos] = ul.to(I32)
    coef = torch.zeros((G, E, CW), dtype=torch.int32, device=dev)
    avt = av.T.to(torch.int32)                         # (LPI * G, MAX_P)

    def add(valid, lane, cols, vals):
        i = torch.searchsorted(uk, key(lane)[valid])
        full = torch.zeros((i.numel(), CW), dtype=torch.int32, device=dev)
        for c, v in zip(cols, vals):
            full[:, c] = v
        coef.index_put_((ug[i], pos[i]), full, accumulate=True)
    add(vs, start, (0, slice(CS, CS + MAX_P), slice(CP, CP + MAX_P)),
        (1, avt[vs], avt[vs]))
    add(ve, end, (slice(CP, CP + MAX_P),), (-avt[ve],))
    return lanes, coef.to(torch.int16)


def lane_tables(tabs):
    """The kernel's tables: lanes (G, E) int32, each intersection's
    distinct start and end lanes (-1 pads), and coef (G, E, CW) int16, per
    lane the counts of the intersection's links that start there (word
    0), that start there and are available in phase ph (word CS + ph), and
    that less those that end there and are available in ph (word CP + ph),
    for every ph < MAX_P. Static net structure, as the tables they come
    from (nothing writes those after the net is built): built on first use
    and kept in tabs[LANES] / tabs[COEF]."""
    if LANES not in tabs:
        tabs[LANES], tabs[COEF] = _build(tabs)
    return tabs[LANES], tabs[COEF]


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
    dev = w.device
    lanes, coef = lane_tables(tabs)
    kw = dict(w=w.data_ptr(), lanes=lanes.data_ptr(), coef=coef.data_ptr(),
              g_nph=tabs["g_n_phases"].data_ptr(), G=G, I=I,
              E=lanes.shape[1], N=N, B=B, P=P)
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
