"""L4 lc_partner: each row's partner values by uid match in the partner's
lane column (csrc/lc_partner.cu), in two modes.

Real and shadow share the uid; the shadow carries l_sh, both carry the
change direction l_dir. A real looks toward l_dir, a shadow toward
-l_dir, at that neighbour column (the outer one where that is > 0, else
the inner one), and takes the first occupied slot with its uid and the
other shadow flag.

  lc_partner         the match mode: finds each row's partner, returns
                     ([C x (SL, LNp, B) float32 values, 0 without a
                     match], found, match). found = a match on a row that
                     is paired (an occupied changing real or shadow with
                     a direction); match (SL, LNp, B) int16 = the
                     partner's slot, bit 14 set on the outer side, -1
                     without a match. The values are returned for every
                     row, paired or not, as the JAX step's are.
  lc_partner_gather  the gather mode: the values of other channels at a
                     match found before on the same uid, sh, dir and n_l,
                     with no search.

A lane-change ring step matches once (p1) and gathers twice (the commit's
pair rounds): nothing writes those leaves in between.
"""

import ctypes

import torch

from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels._nbr import nbcol

launches = 0
launches_gather = 0    # gather-mode launches among them
MAX_C = 4
MAX_S = 16384          # the slot field of `match` (bits 0-13)
OUTER = 1 << 14        # the side bit of `match`
I32_MAX = 2 ** 31 - 1


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "uid", "sh", "dir", "n_l", "chg")] \
        + [("ch", ctypes.c_void_p * MAX_C), ("C", ctypes.c_int)] \
        + [(n, ctypes.c_void_p) for n in ("out", "found", "match", "inner",
                                          "outer")] \
        + [(n, ctypes.c_int) for n in ("S", "N", "B")]


def lc_partner_plain(uid, sh, l_dir, n_l, chg, chans, tabs):
    """Plain PyTorch version of ring_lc.partner_fetch (ring_lc.py:534-567),
    with the match."""
    SL = uid.shape[0]
    dev = uid.device
    occ = torch.arange(SL, device=dev)[:, None, None] < n_l[None]
    look = torch.where(sh, -l_dir, l_dir)
    use_out = look > 0
    inner, outer = tabs["inner_src"], tabs["outer_src"]

    n_o, n_i = nbcol(n_l, outer), nbcol(n_l, inner)
    cols = [(nbcol(x, outer), nbcol(x, inner)) for x in [uid, sh] + chans]
    found = torch.zeros(uid.shape, dtype=torch.bool, device=dev)
    hit = torch.full(uid.shape, -1, dtype=torch.int32, device=dev)
    out = [torch.zeros(uid.shape, device=dev) for _ in chans]
    for t in range(SL):
        # the partner column's slot t, seen from each of my rows
        P = [torch.where(use_out, xo[t], xi[t]) for xo, xi in cols]
        occ_t = torch.where(use_out, t < n_o, t < n_i)
        m = occ_t & (P[0] == uid) & (P[1] != sh) & ~found
        for i in range(len(chans)):
            out[i] = torch.where(m, P[2 + i], out[i])
        hit = torch.where(m, t, hit)
        found = found | m
    paired = occ & ((chg & ~sh) | sh) & (look != 0)
    match = torch.where(found, hit | (use_out.to(torch.int32) * OUTER), -1)
    return out, found & paired, match.to(torch.int16)


def lc_partner_gather_plain(match, chans, tabs):
    """Plain PyTorch version of the gather mode: each channel at the row
    `match` names, 0 where it is -1."""
    SL, N, B = match.shape
    dev = match.device
    m = match.to(torch.int64)
    ok = m >= 0
    q = torch.where((m & OUTER) > 0, tabs["outer_src"][:, None].long(),
                    tabs["inner_src"][:, None].long())
    b = torch.arange(B, device=dev)
    flat = torch.where(ok, ((m & (OUTER - 1)) * N + q) * B + b, 0)
    return [torch.where(ok, c.reshape(-1)[flat], 0.0) for c in chans]


def fits(SL, N, B):
    """The match keeps the slot in 14 bits and the kernel's offsets are
    32-bit: SL above MAX_S or SL * N * B past 2^31 raises (the CPU path
    too, so that the tests see the refusal)."""
    if SL > MAX_S:
        raise ValueError(f"lc_partner: S={SL} does not fit the match's "
                         "14-bit slots")
    if SL * N * B > I32_MAX:
        raise ValueError(f"lc_partner: S={SL} N={N} B={B} do not fit the "
                         "kernel's 32-bit offsets")


def _check(name, chans, SL, N, B):
    C = len(chans)
    if not 1 <= C <= MAX_C:
        raise ValueError(f"{name}: {C} channels")
    for t in chans:
        if tuple(t.shape) != (SL, N, B):
            raise ValueError(f"{name}: channel {tuple(t.shape)}")
    fits(SL, N, B)


def lc_partner(uid, sh, l_dir, n_l, chg, chans, tabs):
    """L4's match mode on CUDA tensors, the plain version on CPU tensors.
    uid / sh / l_dir / chg (SL, LNp, B), n_l (LNp, B), chans: up to MAX_C
    float32 (SL, LNp, B) channels. Returns (values, found, match)."""
    global launches
    SL, N, B = uid.shape
    cpu = uid.device.type == "cpu"
    f32, i32, b8 = (torch.float32,), (torch.int32,), (torch.bool,)
    _lib.check_args("lc_partner", uid, sh, l_dir, n_l, chg,
                    tabs["inner_src"], tabs["outer_src"], *chans,
                    dtypes=[i32, b8, i32, i32, b8, i32, i32]
                    + [f32] * len(chans), cuda=not cpu)
    for t in (sh, l_dir, chg):
        if tuple(t.shape) != (SL, N, B):
            raise ValueError(f"lc_partner: ring {tuple(t.shape)}")
    if tuple(n_l.shape) != (N, B):
        raise ValueError(f"lc_partner: n_l {tuple(n_l.shape)}")
    _check("lc_partner", chans, SL, N, B)
    if cpu:
        return lc_partner_plain(uid, sh, l_dir, n_l, chg, chans, tabs)
    dev = uid.device
    out = torch.empty((len(chans), SL, N, B), dtype=torch.float32,
                      device=dev)
    found = torch.empty((SL, N, B), dtype=torch.bool, device=dev)
    match = torch.empty((SL, N, B), dtype=torch.int16, device=dev)
    _launch(0, dict(uid=uid, sh=sh, dir=l_dir, n_l=n_l, chg=chg, out=out,
                    found=found, match=match), chans, tabs, SL, N, B)
    launches += 1
    return list(out), found, match


def lc_partner_gather(match, chans, tabs):
    """L4's gather mode on CUDA tensors, the plain version on CPU tensors:
    match (SL, LNp, B) int16 from lc_partner on the same leaves, chans up
    to MAX_C float32 (SL, LNp, B) channels. Returns their values."""
    global launches, launches_gather
    SL, N, B = match.shape
    cpu = match.device.type == "cpu"
    _lib.check_args("lc_partner_gather", match, tabs["inner_src"],
                    tabs["outer_src"], *chans,
                    dtypes=[(torch.int16,), (torch.int32,), (torch.int32,)]
                    + [(torch.float32,)] * len(chans), cuda=not cpu)
    _check("lc_partner_gather", chans, SL, N, B)
    if cpu:
        return lc_partner_gather_plain(match, chans, tabs)
    out = torch.empty((len(chans), SL, N, B), dtype=torch.float32,
                      device=match.device)
    _launch(1, dict(match=match, out=out), chans, tabs, SL, N, B)
    launches += 1
    launches_gather += 1
    return list(out)


def _launch(mode, ptrs, chans, tabs, SL, N, B):
    chp = (ctypes.c_void_p * MAX_C)(*[c.data_ptr() for c in chans])
    a = _Args(ch=chp, C=len(chans), inner=tabs["inner_src"].data_ptr(),
              outer=tabs["outer_src"].data_ptr(), S=SL, N=N, B=B,
              **{k: v.data_ptr() for k, v in ptrs.items()})
    rc = _lib.lib().lc_partner(ctypes.byref(a), mode,
                               _lib.stream_ptr(ptrs["match"]))
    _lib.check(rc, "lc_partner")
