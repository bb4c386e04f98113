"""L4 lc_partner: each paired row's partner values by uid match in the
partner's lane column (csrc/lc_partner.cu).

Real and shadow share the uid; the shadow carries l_sh, both carry the
change direction l_dir. A real looks toward l_dir, a shadow toward
-l_dir, at that neighbour column, and takes the first occupied slot with
its uid and the other shadow flag. One thread per (slot, lane, env) walks
the partner column and reads C channels at the match.

Returns ([C x (SL, LNp, B) float32 values, 0 without a match], found):
found = a match on a row that is paired (an occupied changing real or
shadow with a direction). The values are returned for every row, paired or
not, as the JAX step's are.
"""

import ctypes

import torch

from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels._nbr import nbcol

launches = 0
MAX_C = 4


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "uid", "sh", "dir", "n_l", "chg")] \
        + [("ch", ctypes.c_void_p * MAX_C), ("C", ctypes.c_int)] \
        + [(n, ctypes.c_void_p) for n in ("out", "found", "inner", "outer")] \
        + [(n, ctypes.c_longlong) for n in ("S", "N", "B")]


def lc_partner_plain(uid, sh, l_dir, n_l, chg, chans, tabs):
    """Plain PyTorch version of ring_lc.partner_fetch (ring_lc.py:534-567)."""
    SL = uid.shape[0]
    dev = uid.device
    occ = torch.arange(SL, device=dev)[:, None, None] < n_l[None]
    look = torch.where(sh, -l_dir, l_dir)
    use_out = look > 0
    inner, outer = tabs["inner_src"], tabs["outer_src"]

    n_o, n_i = nbcol(n_l, outer), nbcol(n_l, inner)
    cols = [(nbcol(x, outer), nbcol(x, inner)) for x in [uid, sh] + chans]
    found = torch.zeros(uid.shape, dtype=torch.bool, device=dev)
    out = [torch.zeros(uid.shape, device=dev) for _ in chans]
    for t in range(SL):
        # the partner column's slot t, seen from each of my rows
        P = [torch.where(use_out, xo[t], xi[t]) for xo, xi in cols]
        occ_t = torch.where(use_out, t < n_o, t < n_i)
        m = occ_t & (P[0] == uid) & (P[1] != sh) & ~found
        for i in range(len(chans)):
            out[i] = torch.where(m, P[2 + i], out[i])
        found = found | m
    paired = occ & ((chg & ~sh) | sh) & (look != 0)
    return out, found & paired


def lc_partner(uid, sh, l_dir, n_l, chg, chans, tabs):
    """L4 on CUDA tensors, the plain version on CPU tensors. uid / sh /
    l_dir / chg (SL, LNp, B), n_l (LNp, B), chans: up to MAX_C float32
    (SL, LNp, B) channels."""
    global launches
    SL, N, B = uid.shape
    C = len(chans)
    if not 1 <= C <= MAX_C:
        raise ValueError(f"lc_partner: {C} channels")
    cpu = uid.device.type == "cpu"
    f32, i32, b8 = (torch.float32,), (torch.int32,), (torch.bool,)
    _lib.check_args("lc_partner", uid, sh, l_dir, n_l, chg,
                    tabs["inner_src"], tabs["outer_src"], *chans,
                    dtypes=[i32, b8, i32, i32, b8, i32, i32] + [f32] * C,
                    cuda=not cpu)
    for t in (sh, l_dir, chg, *chans):
        if tuple(t.shape) != (SL, N, B):
            raise ValueError(f"lc_partner: ring {tuple(t.shape)}")
    if tuple(n_l.shape) != (N, B):
        raise ValueError(f"lc_partner: n_l {tuple(n_l.shape)}")
    if cpu:
        return lc_partner_plain(uid, sh, l_dir, n_l, chg, chans, tabs)
    out = torch.empty((C, SL, N, B), dtype=torch.float32, device=uid.device)
    found = torch.empty((SL, N, B), dtype=torch.bool, device=uid.device)
    chp = (ctypes.c_void_p * MAX_C)(*[c.data_ptr() for c in chans])
    a = _Args(uid.data_ptr(), sh.data_ptr(), l_dir.data_ptr(),
              n_l.data_ptr(), chg.data_ptr(), chp, C, out.data_ptr(),
              found.data_ptr(), tabs["inner_src"].data_ptr(),
              tabs["outer_src"].data_ptr(), SL, N, B)
    rc = _lib.lib().lc_partner(ctypes.byref(a), _lib.stream_ptr(uid))
    _lib.check(rc, "lc_partner")
    launches += 1
    return list(out), found
