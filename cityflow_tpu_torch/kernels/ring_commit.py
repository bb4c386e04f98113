"""K4 ring_commit: shift every ring column out by its front departures and
append its entrants, for all channels in one pass (csrc/ring_commit.cu).

Rings are (S, N, B): S slots (slot 0 = front), N columns (drivables), B
envs. Per column and env, slot s takes slot s + x (or the channel's fill
past the end), then the selected entrants land at base, base + 1, ... in
order. Entrant candidates are `app`, (A, PCH, AC, B) float32: channel
`valid_ch` > 0.5 marks a real candidate. Without `sort_ch` the first `nsel`
candidates are taken in order (the link ring); with it, the candidates are
stably sorted by that channel descending, valid first, and the first `nsel`
taken (the lane ring's pushBuffer order). Column n maps to entrant column n,
or with `app_I` to ol * app_G + g for n = ol * app_I + g, g < app_G.

Channels are (upd, kind, fill, app_ch, app_ch2):
  "f32"  float ring, float entrant
  "i32"  int ring; the entrant and fill pass XLA's saturating cast
  "bool" bool ring; entrant and fill > 0.5
  "pri"  int priority; entrant = (hi << 16) | lo from channels app_ch and
         app_ch2 (the (hi, lo) f32 halves of the JAX exchange)
app_ch = -1 takes the per-env value envval[b].

The lane-change mode (the JAX lane commit under cfg.lane_change,
ring.py:1815-1857) takes a delete mask `dmask` (S, N, B) instead of the
front departures x: the kept slots close up in order (a rank-preserving
delete of front exits and mid-ring finishes), a kept slot moving up by more
than XD = min(XK + LCD, S) is dropped as the JAX where-chain drops it, and
the entrants append at base as before.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.numerics import xla_f32_to_i32
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_lc = 0         # of those, in the lane-change mode (dmask)
KINDS = {"f32": 0, "i32": 1, "bool": 2, "pri": 3}
MAX_CH = 32
MAX_A = 16


class _Chan(ctypes.Structure):
    _fields_ = [("upd", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("kind", ctypes.c_int), ("app_ch", ctypes.c_int),
                ("app_ch2", ctypes.c_int), ("fill", ctypes.c_float)]


class _Args(ctypes.Structure):
    _fields_ = [("ch", _Chan * MAX_CH), ("nch", ctypes.c_int),
                ("XK", ctypes.c_int)] \
        + [(n, ctypes.c_longlong) for n in ("S", "N", "B")] \
        + [("x", ctypes.c_void_p), ("base", ctypes.c_void_p),
           ("app", ctypes.c_void_p)] \
        + [(n, ctypes.c_longlong) for n in ("A", "PCH", "AC", "app_I",
                                            "app_G")] \
        + [("valid_ch", ctypes.c_int), ("sort_ch", ctypes.c_int),
           ("nsel", ctypes.c_int), ("envval", ctypes.c_void_p),
           ("dmask", ctypes.c_void_p), ("XD", ctypes.c_int)]


def _from_hilo(h, l):
    return (xla_f32_to_i32(h) << 16) | xla_f32_to_i32(l)


def _as_kind(v, kind):
    """A float32 entrant value (tensor) as the ring's dtype."""
    if kind == "f32":
        return v
    if kind == "bool":
        return v > 0.5
    return xla_f32_to_i32(v)


def _fill_of(fill, kind, dev):
    f = torch.tensor(float(fill), dtype=torch.float32, device=dev)
    if kind == "pri":
        return _from_hilo(f, f)
    return _as_kind(f, kind)


def _app_columns(app, N, app_I, app_G):
    """(A, PCH, AC, B) -> (A, PCH, N, B); unmapped columns are invalid."""
    if not app_I:
        return app
    n = torch.arange(N, device=app.device)
    g = n % app_I
    col = torch.where(g < app_G, (n // app_I) * app_G + g, -1)
    got = app.index_select(2, col.clamp(min=0))
    return torch.where((col >= 0)[None, None, :, None], got, 0.0)


def _delete_shift(upd, dmask, XD, pad):
    """The JAX generalized rank-preserving delete: out[s] = upd[s + x]
    where s + x is kept and x earlier slots are deleted, x <= XD, else the
    fill."""
    S, N, B = upd.shape
    dmi = dmask.to(torch.int32)
    dex = torch.cumsum(dmi, dim=0, dtype=torch.int32) - dmi
    del_pad = torch.cat([dmask, torch.ones((XD, N, B), dtype=torch.bool,
                                           device=upd.device)])
    dex_pad = torch.cat([dex, torch.full((XD, N, B), S + XD,
                                         dtype=torch.int32,
                                         device=upd.device)])
    upd_pad = torch.cat([upd, pad.expand(XD, N, B).to(upd.dtype)])
    out = pad.expand(S, N, B).to(upd.dtype)
    for xx in range(XD + 1):
        cond = ~del_pad[xx:xx + S] & (dex_pad[xx:xx + S] == xx)
        out = torch.where(cond, upd_pad[xx:xx + S], out)
    return out


def ring_commit_plain(chans, x, base, app, valid_ch, sort_ch, nsel, XK,
                      app_I=0, app_G=0, envval=None, dmask=None, XD=0):
    """Plain PyTorch version: the JAX shift_out / append (or the lane-change
    delete), one channel at a time, with torch.sort(stable=True) for the
    candidate order."""
    S, N, B = chans[0][0].shape
    dev = base.device
    appn = _app_columns(app, N, app_I, app_G)
    valid = appn[:, valid_ch] > 0.5                              # (A, N, B)
    A = appn.shape[0]
    if sort_ch >= 0:
        key = torch.where(valid, -appn[:, sort_ch], torch.inf)
        order = torch.sort(key, dim=0, stable=True).indices[:nsel]
    else:
        order = torch.arange(A, device=dev)[:nsel, None, None] \
            .expand(nsel, N, B)
    take = lambda v: torch.gather(v, 0, order)                   # (nsel,N,B)
    sv = take(valid)
    svi = sv.to(torch.int32)
    prev = torch.cumsum(svi, dim=0, dtype=torch.int32) - svi
    s_idx = torch.arange(S, device=dev)[:, None, None]
    outs = []
    for upd, kind, fill, app_ch, app_ch2 in chans:
        if dmask is not None:
            out = _delete_shift(upd, dmask, XD, _fill_of(fill, kind, dev))
        else:
            pad = _fill_of(fill, kind, dev).expand(XK, N, B)
            upd_pad = torch.cat([upd, pad.to(upd.dtype)], dim=0)
            out = upd_pad[:S]
            for xx in range(1, XK + 1):
                out = torch.where((x == xx)[None], upd_pad[xx:xx + S], out)
        if app_ch < 0:
            vals = envval[None, None, :].expand(nsel, N, B)
        else:
            vals = take(appn[:, app_ch])
        if kind == "pri":
            vals = _from_hilo(vals, take(appn[:, app_ch2]))
        else:
            vals = _as_kind(vals, kind)
        for j in range(nsel):
            place = (s_idx == (base + prev[j])[None]) & sv[j][None]
            out = torch.where(place, vals[j][None], out)
        outs.append(out.contiguous())
    return outs


def ring_commit(chans, x, base, app, valid_ch, sort_ch, nsel, XK, app_I=0,
                app_G=0, envval=None, dmask=None, XD=0):
    """K4 on CUDA tensors, the plain version on CPU tensors. Returns the
    committed ring of every channel, in order. With `dmask` (the
    lane-change mode) x is not read and may be None."""
    global launches, launches_lc
    cpu = base.device.type == "cpu"
    S, N, B = chans[0][0].shape
    A, PCH, AC, B2 = app.shape
    if dmask is None:
        if x is None or tuple(x.shape) != (N, B):
            raise ValueError("ring_commit: x must be (N, B)")
    elif tuple(dmask.shape) != (S, N, B) or dmask.dtype != torch.bool \
            or not 0 <= XD <= S:
        raise ValueError("ring_commit: dmask must be (S, N, B) bool, "
                         "0 <= XD <= S")
    else:
        x = None
    dtypes = {"f32": torch.float32, "i32": torch.int32, "bool": torch.bool,
              "pri": torch.int32}
    if len(chans) > MAX_CH or A > MAX_A or nsel > A:
        raise ValueError("ring_commit: too many channels or candidates")
    if B2 != B or tuple(base.shape) != (N, B):
        raise ValueError("ring_commit: base/app shapes do not match")
    if envval is not None and tuple(envval.shape) != (B,):
        raise ValueError("ring_commit: envval must be (B,)")
    _lib.check_args("ring_commit", x, base, app, envval, dmask,
                    dtypes=[(torch.int32,), (torch.int32,),
                            (torch.float32,), (torch.float32,),
                            (torch.bool,)], cuda=not cpu)
    for i, (upd, kind, fill, app_ch, app_ch2) in enumerate(chans):
        _lib.check_args("ring_commit", upd, dtypes=[(dtypes[kind],)],
                        cuda=not cpu)
        if tuple(upd.shape) != (S, N, B):
            raise ValueError(f"ring_commit: channel {i} {tuple(upd.shape)}")
        if not (-1 <= app_ch < PCH and 0 <= app_ch2 < PCH):
            raise ValueError(f"ring_commit: channel {i} entrant index")
        if app_ch < 0 and envval is None:
            raise ValueError("ring_commit: app_ch -1 needs envval")
    if cpu:
        return ring_commit_plain(chans, x, base, app, valid_ch, sort_ch,
                                 nsel, XK, app_I, app_G, envval, dmask, XD)
    cs = (_Chan * MAX_CH)()
    outs = []
    for i, (upd, kind, fill, app_ch, app_ch2) in enumerate(chans):
        out = torch.empty_like(upd)
        outs.append(out)
        cs[i] = _Chan(upd.data_ptr(), out.data_ptr(), KINDS[kind], app_ch,
                      app_ch2, float(fill))
    ptr = lambda t: None if t is None else t.data_ptr()
    a = _Args(cs, len(chans), XK, S, N, B, ptr(x), base.data_ptr(),
              app.data_ptr(), A, PCH, AC, app_I, app_G, valid_ch, sort_ch,
              nsel, ptr(envval), ptr(dmask), XD)
    rc = _lib.lib().ring_commit(ctypes.byref(a), _lib.stream_ptr(base))
    _lib.check(rc, "ring_commit")
    launches += 1
    launches_lc += dmask is not None
    return outs
