"""L3 lc_insert: per target lane up to LCI shadow winners, the senders'
change start, and the rank-preserving shadow inserts of every lane channel
(csrc/lc_insert.cu, two kernels launched together; one launch count).

  select   one thread per (target lane, env): of the senders that decided
           to change into this lane (inner lane direction +1, then outer
           lane direction -1, slots ascending), take up to LCI by distance
           descending (a tie keeps the first); more than LCI sets
           overflow bit 1
  insert   one thread per (lane, env): each winner's shadow goes in after
           every slot with dis >= its dis (LaneChange::insertShadow); the
           senders whose shadow got a slot start changing (chg, dir); every
           channel is written once, the winner's values read from the
           source column by index; a full ring sets overflow bit 2

Channels are the lane ring leaves by name (CHANNELS). A winner copies its
real's values, except: nxt / nxt3 come from its route rows at the target
lane index, pri = SHBIT + uid, dir = its change direction, and the
constants of CONSTS (a shadow: off 0, sh, not changing, no yield, no
custom speed).
"""

import ctypes

import torch

from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels._nbr import nbcol
from cityflow_tpu_torch.kernels.lc_signal import sel_llocal

launches = 0
SHBIT = 1 << 30          # shadow priority offset (gen-1 lanechange.py:248)
MAX_CH = 40
MAX_LCI = 8

# (name, kind, winner rule); rn0.. / ax0.. (route rows, i32, same) follow
CHANNELS = (("dis", "f32", "same"), ("speed", "f32", "same"),
            ("flow", "i32", "same"), ("route", "i32", "same"),
            ("rpos", "i32", "same"), ("nxt", "i32", "nxt"),
            ("nxt3", "i32", "nxt3"), ("prev", "i32", "same"),
            ("enter", "f32", "same"), ("pri", "i32", "pri"),
            ("uid", "i32", "same"), ("last", "bool", "same"),
            ("gap", "f32", "same"), ("dir", "i32", "dir"),
            ("off", "f32", "const"), ("sh", "bool", "const"),
            ("chg", "bool", "const"), ("yv", "f32", "const"),
            ("custom", "f32", "const"), ("hascustom", "bool", "const"))
CONSTS = {"off": 0.0, "sh": 1.0, "chg": 0.0, "yv": 100.0, "custom": 0.0,
          "hascustom": 0.0}
KINDS = {"f32": 0, "i32": 1, "bool": 2}
WIN = {"same": 0, "const": 1, "nxt": 2, "nxt3": 3, "pri": 4, "dir": 5}
ORIG = {"chg": 1, "dir": 2}     # ring value before the inserts: chg2, dir2
DTYPES = {"f32": torch.float32, "i32": torch.int32, "bool": torch.bool}


class _Chan(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("kind", ctypes.c_int), ("win", ctypes.c_int),
                ("orig", ctypes.c_int), ("cval", ctypes.c_float)]


class _Args(ctypes.Structure):
    _fields_ = [("ch", _Chan * MAX_CH), ("nch", ctypes.c_int)] \
        + [(n, ctypes.c_void_p) for n in (
            "acc", "do_change", "dirc", "sh", "chg", "dir", "dis", "n_l",
            "uid", "rnrow", "auxrow", "inner", "outer", "llocal", "n_out",
            "ovl")] \
        + [(n, ctypes.c_longlong) for n in ("S", "N", "B")] \
        + [("LCI", ctypes.c_int), ("M", ctypes.c_int)]


def channel_spec(M):
    """CHANNELS plus the route rows rn0..rn{M-1}, ax0..ax{M-1}."""
    return CHANNELS + tuple((f"{p}{c}", "i32", "same")
                            for p in ("rn", "ax") for c in range(M))


def _ring_of(ch, name):
    """A channel's (SL, LNp, B) ring: rn{c} / ax{c} are rows of the
    (M, SL, LNp, B) rnrow / auxrow bundles."""
    if name[:2] in ("rn", "ax") and name[2:].isdigit():
        return ch["rnrow" if name[:2] == "rn" else "auxrow"][int(name[2:])]
    return ch[name]


def lc_insert_plain(ch, do_change, dirc, yv, n_l, tabs, LCI):
    """Plain PyTorch version of ring_lc.lc_phase's winner selection,
    started flags and shadow inserts (ring_lc.py:369-531), reading the
    winners' bundles from their source column by index."""
    SL, LNp, B = ch["dis"].shape
    dev = n_l.device
    i32 = torch.int32
    inner, outer = tabs["inner_src"], tabs["outer_src"]
    sl_iota = torch.arange(SL, device=dev)[:, None, None]
    occ = sl_iota < n_l[None]
    dis = ch["dis"]
    src = ((nbcol(do_change, inner), nbcol(dirc, inner), nbcol(dis, inner),
            1),
           (nbcol(do_change, outer), nbcol(dirc, outer), nbcol(dis, outer),
            -1))
    ncand = torch.zeros((LNp, B), dtype=i32, device=dev)
    for dc, dd, _, want in src:
        ncand += ((dc & (dd == want)).to(i32)).sum(0, dtype=i32)
    ov = (ncand > LCI).to(torch.uint8)

    accepted = []                     # per j: (LNp, B) code = side*SL+slot
    for j in range(LCI):
        w_dis = torch.full((LNp, B), -torch.inf, device=dev)
        w_code = torch.full((LNp, B), -1, dtype=i32, device=dev)
        for side, (dc, dd, ds, want) in enumerate(src):
            for t in range(SL):
                code = side * SL + t
                used = torch.zeros((LNp, B), dtype=torch.bool, device=dev)
                for a in accepted:
                    used = used | (a == code)
                better = dc[t] & (dd[t] == want) & ~used & (ds[t] > w_dis)
                w_dis = torch.where(better, ds[t], w_dis)
                w_code = torch.where(better, code, w_code)
        accepted.append(w_code)

    # senders whose shadow got a slot: my code as my target lane sees it
    # (neighbour columns without a lane read 0, as the JAX permutation does)
    my_code = torch.where(dirc > 0, sl_iota, SL + sl_iota)
    inserted = torch.zeros((SL, LNp, B), dtype=torch.bool, device=dev)
    for a in accepted:
        a_t = torch.where(dirc > 0, nbcol(a, outer)[None], nbcol(a, inner)[None])
        inserted = inserted | (a_t == my_code)
    started = do_change & inserted
    chg2 = ch["chg"] | started
    dir2 = torch.where(ch["sh"], ch["dir"], torch.where(chg2, dirc, 0)) \
        .to(i32)

    # the shadow's values on the sender rows (copied real, target lane's
    # route rows, shadow priority)
    llocal = tabs["ln_llocal"]
    up = dirc > 0
    sh_nxt = torch.where(up, sel_llocal(ch["rnrow"], llocal, 1),
                         sel_llocal(ch["rnrow"], llocal, -1))
    aux_t = torch.where(up, sel_llocal(ch["auxrow"], llocal, 1),
                        sel_llocal(ch["auxrow"], llocal, -1))
    sender = {"nxt": sh_nxt,
              "nxt3": torch.where(aux_t >= 0, (aux_t >> 1) - 2, -1).to(i32),
              "pri": SHBIT + ch["uid"], "dir": dirc}
    spec = channel_spec(ch["rnrow"].shape[0])
    cur = {name: {"chg": chg2, "dir": dir2, "yv": yv}.get(name)
           if name in ("chg", "dir", "yv") else _ring_of(ch, name)
           for name, _, _ in spec}

    def winner(j, name, rule):
        a = accepted[j]
        if rule == "const":
            return torch.full((LNp, B), CONSTS[name], device=dev)
        ring = sender[name] if rule in sender else _ring_of(ch, name)
        side, t = a // SL, a % SL
        q = torch.where(side == 0, inner[:, None], outer[:, None])
        flat = (t * LNp + q).clamp(min=0).long()
        got = torch.gather(ring.reshape(SL * LNp, B), 0, flat)
        return torch.where(a >= 0, got, torch.zeros((), dtype=got.dtype,
                                                    device=dev))

    n_cur = n_l
    for j in range(LCI):
        ex = accepted[j] >= 0
        w_dis = winner(j, "dis", "same")
        pos = (occ & (dis >= w_dis[None])).to(i32).sum(0, dtype=i32) + j
        ov = ov | ((ex & (n_cur >= SL)).to(torch.uint8) * 2)
        ex = ex & (n_cur < SL)
        below = (sl_iota > pos[None]) & ex[None]
        at = (sl_iota == pos[None]) & ex[None]
        for name, kind, rule in spec:
            a = cur[name]
            v = winner(j, name, rule)
            if v.dtype != a.dtype:          # the constants
                v = v > 0.5 if kind == "bool" else v.to(a.dtype)
            shifted = torch.cat([torch.zeros_like(a[:1]), a[:-1]])
            cur[name] = torch.where(below, shifted,
                                    torch.where(at, v[None], a))
        n_cur = n_cur + ex.to(i32)
    return cur, n_cur, ov


def lc_insert(ch, do_change, dirc, yv, n_l, tabs, LCI):
    """L3 on CUDA tensors, the plain version on CPU tensors.

    ch: the lane ring channels by name (dis, speed, flow, route, rpos, nxt,
    nxt3, prev, enter, pri, uid, last, gap, dir, off, sh, chg, custom,
    hascustom as (SL, LNp, B), rnrow / auxrow as (M, SL, LNp, B)); do_change
    and dirc from L1 / L2, yv from L2. Returns ({name: new ring} for every
    channel of channel_spec(M), new n_l, overflow bits (LNp, B) uint8)."""
    global launches
    SL, N, B = ch["dis"].shape
    M = ch["rnrow"].shape[0]
    spec = channel_spec(M)
    if LCI > MAX_LCI or len(spec) > MAX_CH:
        raise ValueError("lc_insert: too many inserts or channels")
    cpu = n_l.device.type == "cpu"
    rings = [ch[k] for k in ch] + [do_change, dirc, yv]
    _lib.check_args("lc_insert", *rings, n_l, tabs["inner_src"],
                    tabs["outer_src"], tabs["ln_llocal"], cuda=not cpu)
    for name, kind, _ in spec:
        if name in ORIG or name == "yv":
            continue
        t = _ring_of(ch, name)
        if t.dtype != DTYPES[kind] or tuple(t.shape) != (SL, N, B):
            raise ValueError(f"lc_insert: channel {name} {t.dtype} "
                             f"{tuple(t.shape)}")
    if cpu:
        return lc_insert_plain(ch, do_change, dirc, yv, n_l, tabs, LCI)
    dev = n_l.device
    acc = torch.empty((LCI, N, B), dtype=torch.int32, device=dev)
    ovl = torch.empty((N, B), dtype=torch.uint8, device=dev)
    n_out = torch.empty((N, B), dtype=torch.int32, device=dev)
    cs = (_Chan * MAX_CH)()
    outs = {}
    for i, (name, kind, rule) in enumerate(spec):
        out = torch.empty((SL, N, B), dtype=DTYPES[kind], device=dev)
        outs[name] = out
        srcp = None if name in ORIG else (
            yv if name == "yv" else _ring_of(ch, name)).data_ptr()
        cs[i] = _Chan(srcp, out.data_ptr(), KINDS[kind], WIN[rule],
                      ORIG.get(name, 0), float(CONSTS.get(name, 0.0)))
    a = _Args(cs, len(spec), acc.data_ptr(), do_change.data_ptr(),
              dirc.data_ptr(), ch["sh"].data_ptr(), ch["chg"].data_ptr(),
              ch["dir"].data_ptr(), ch["dis"].data_ptr(), n_l.data_ptr(),
              ch["uid"].data_ptr(), ch["rnrow"].data_ptr(),
              ch["auxrow"].data_ptr(), tabs["inner_src"].data_ptr(),
              tabs["outer_src"].data_ptr(), tabs["ln_llocal"].data_ptr(),
              n_out.data_ptr(), ovl.data_ptr(), SL, N, B, LCI, M)
    rc = _lib.lib().lc_insert(ctypes.byref(a), _lib.stream_ptr(n_l))
    _lib.check(rc, "lc_insert")
    launches += 1
    return outs, n_out, ovl
