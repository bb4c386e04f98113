"""K2 cross_caps: Cross::canPass for a batch of rows over each link's
crosses (csrc/cross_caps.cu).

Rows are (R, LK, B): R vehicle rows per link, LK = LPI * G links, B envs.
The cross tables `tabs` are (KC, LK) (`d`, `cvalid`, `t2`, `foelpi`) and
(LK,) (`t1`, `turn`). The foe channels are read in place: `fields` is R1's
(9, NF, B) notifier fields (exists, yield, cleared, cycle, reach,
distance, enter time, priority high and low half) and `foe_src` the
(KC * LK,) int32 row of fields each cross's foe is in; a cross whose
foe_src is -1 reads +0.0 in every channel (no foe: it passes), as the
gathered (9, KC, LK, B) slab of the JAX foe exchange holds there.
Returns any_fail (bool), the first failing cross's distance
ff_d (+inf if none) and its foe lpi ff_foe (-1 if none). Parameters are
the subject's maxNegAcc, yield distance, length, turn speed, max speed,
usualPosAcc and the step interval, as Python floats.

The template mode (non-uniform vehicle templates; JAX ring.py:942-954)
takes `tpl`, the (R, LK, B) int32 template index of each row, and the
(TP, 12) table `table`: the subject's parameters come from its template;
of `prm` only the interval is read. Its own instantiation.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.step import can_yield, reach_steps
from cityflow_tpu_torch.compiler.net import (
    P_LEN, P_MAXNEGACC, P_MAXSPEED, P_TURNSPEED, P_USUALPOSACC, P_YIELD)
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels.gather_rows import gather_rows_plain
from cityflow_tpu_torch.kernels.tpl_params import tpl_params_plain

launches = 0
launches_tpl = 0        # of those, in the template mode
launches_app = 0        # of those, with one enter time for every row
TPL_COLS = (P_MAXNEGACC, P_YIELD, P_LEN, P_TURNSPEED, P_MAXSPEED,
            P_USUALPOSACC)


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "dls", "speed", "ent", "ph", "plo", "relevant", "d", "cvalid", "t2",
        "foelpi", "t1", "turn", "fields", "foe_src", "any_fail", "ff_d",
        "ff_foe")]
        + [(n, ctypes.c_int) for n in ("R", "KC", "LK", "B", "NF")]
        + [(n, ctypes.c_float) for n in (
            "ent_val", "maxneg", "yld", "len", "turnspd", "maxspd", "upa",
            "dt")]
        + [("tpl", ctypes.c_void_p), ("table", ctypes.c_void_p),
           ("TP", ctypes.c_int)])


def cross_caps_plain(dls, speed, ent, ph, plo, relevant, fields, foe_src,
                     tabs, prm, tpl=None, table=None):
    """Plain PyTorch version: the foe exchange as a gather of `fields`
    through `foe_src` (fill +0.0), then the JAX region's arithmetic over
    an explicit (R, KC, LK, B) slab. prm: maxneg, yld, len, turnspd,
    maxspd, upa, dt (Python floats, used as float32 like JAX's f(p)
    constants); with `tpl` the six parameters are the rows' templates'
    ((R, 1, LK, B) each)."""
    _, LK, B = dls.shape
    foe = gather_rows_plain(fields, foe_src, 0.0).reshape(
        fields.shape[0], tabs["d"].shape[0], LK, B)
    maxneg, yld, ln, turnspd, maxspd, upa, dt = (
        torch.tensor(float(v), dtype=torch.float32, device=dls.device)
        for v in prm)
    d = tabs["d"][None, :, :, None]                        # (1, KC, LK, 1)
    d1 = d - dls[:, None]                                  # (R, KC, LK, B)
    if tpl is None:
        target = torch.where(tabs["turn"], turnspd, maxspd)[
            None, None, :, None]
    else:
        maxneg, yld, ln, turnspd, maxspd, upa = (
            x[:, None] for x in tpl_params_plain(tpl, table, TPL_COLS))
        target = torch.where(tabs["turn"][None, None, :, None], turnspd,
                             maxspd)
    self_yield = can_yield(speed[:, None], maxneg, yld, ln, d1)
    sr = torch.clamp_max(reach_steps(speed[:, None], d1, target, upa, dt),
                         255)
    f_exists, f_yield, f_cleared, f_cyc = (foe[i][None] > 0.5
                                           for i in range(4))
    fr, f_dist, f_ent, f_ph, f_plo = (foe[i][None] for i in range(4, 9))
    if not torch.is_tensor(ent):
        ent = torch.full_like(dls, ent)
    pri_win = (ph[:, None] > f_ph) | ((ph[:, None] == f_ph)
                                      & (plo[:, None] > f_plo))
    one = torch.ones((), dtype=torch.int32, device=dls.device)
    same_rank_y = torch.where(
        fr > sr, -one, torch.where(
            fr < sr, one, torch.where(
                ent[:, None] == f_ent,
                torch.where(d1 == f_dist, torch.where(pri_win, -one, one),
                            torch.where(d1 < f_dist, -one, one)),
                torch.where(ent[:, None] < f_ent, -one, one))))
    f_dpos = f_dist > 0
    t_eq = torch.where(f_dpos, same_rank_y,
                       torch.where(f_cleared, -one, one))
    t_lt_pre = torch.where(f_dpos, torch.where(fr > sr, -one, 0 * one),
                           torch.where(f_cleared, -one, 0 * one))
    t_lt = torch.where(t_lt_pre == 0, one, t_lt_pre)
    t1 = tabs["t1"][None, None, :, None]
    t2 = tabs["t2"][None, :, :, None]
    y0 = torch.where(t1 > t2, -one, torch.where(t1 < t2, t_lt, t_eq))
    y = torch.where(~f_yield, one, y0)
    y = torch.where((y == 1) & f_cyc, -one, y)
    passes = ~f_exists | ~self_yield | (y == -1)
    considered = tabs["cvalid"][None, :, :, None] & (d >= dls[:, None]) \
        & relevant[:, None]
    fail = considered & ~passes
    any_fail = torch.any(fail, dim=1)
    ff_d = torch.amin(torch.where(fail, d, torch.inf), dim=1)
    ff_foe = torch.amax(torch.where(
        fail & (d == ff_d[:, None]), tabs["foelpi"][None, :, :, None], -one),
        dim=1)
    return any_fail, ff_d, ff_foe


def cross_caps(dls, speed, ent, ph, plo, relevant, fields, foe_src, tabs,
               prm, tpl=None, table=None):
    """K2 on CUDA tensors, the plain version on CPU tensors. `ent` may be
    a Python float (every row has the same enter time)."""
    global launches, launches_tpl, launches_app
    R, LK, B = dls.shape
    KC = tabs["d"].shape[0]
    cpu = dls.device.type == "cpu"
    f32, i32, b8 = (torch.float32,), (torch.int32,), (torch.bool,)
    ent_t = ent if torch.is_tensor(ent) else None
    rows = (dls, speed, ent_t, ph, plo, relevant)
    tb = (tabs["d"], tabs["cvalid"], tabs["t2"], tabs["foelpi"], tabs["t1"],
          tabs["turn"])
    _lib.check_args("cross_caps", *rows, *tb, fields, foe_src,
                    dtypes=[f32, f32, f32, f32, f32, b8, f32, b8, i32, i32,
                            i32, b8, f32, i32], cuda=not cpu)
    for i, t in enumerate(rows):
        if t is not None and tuple(t.shape) != (R, LK, B):
            raise ValueError(f"cross_caps: row input {i} {tuple(t.shape)}"
                             f" != {(R, LK, B)}")
    for name in ("d", "cvalid", "t2", "foelpi"):
        if tuple(tabs[name].shape) != (KC, LK):
            raise ValueError(f"cross_caps: {name} {tuple(tabs[name].shape)}"
                             f" != {(KC, LK)}")
    if tuple(tabs["t1"].shape) != (LK,) or tuple(tabs["turn"].shape) != (LK,):
        raise ValueError("cross_caps: t1/turn must be (LK,)")
    if fields.dim() != 3 or fields.shape[0] != 9 or fields.shape[2] != B \
            or tuple(foe_src.shape) != (KC * LK,):
        raise ValueError(f"cross_caps: fields {tuple(fields.shape)} / "
                         f"foe_src {tuple(foe_src.shape)}")
    if (tpl is None) != (table is None):
        raise ValueError("cross_caps: the template mode takes tpl and table")
    if tpl is not None:
        _lib.check_args("cross_caps", tpl, table,
                        dtypes=[(torch.int32,), (torch.float32,)],
                        cuda=not cpu)
        if tuple(tpl.shape) != (R, LK, B) or table.dim() != 2 \
                or table.shape[1] != 12:
            raise ValueError(f"cross_caps: tpl {tuple(tpl.shape)} / table "
                             f"{tuple(table.shape)}")
    if cpu:
        return cross_caps_plain(dls, speed, ent, ph, plo, relevant, fields,
                                foe_src, tabs, prm, tpl, table)
    if max(R * LK * B, fields.numel(), KC * LK) >= 2 ** 31:
        raise ValueError("cross_caps: the kernel indexes in 32 bits")
    any_fail = torch.empty((R, LK, B), dtype=torch.bool, device=dls.device)
    ff_d = torch.empty((R, LK, B), dtype=torch.float32, device=dls.device)
    ff_foe = torch.empty((R, LK, B), dtype=torch.int32, device=dls.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    a = _Args(*(ptr(t) for t in (*rows, *tb, fields, foe_src, any_fail, ff_d,
                                  ff_foe)),
              R, KC, LK, B, fields.shape[1],
              0.0 if ent_t is not None else float(ent),
              *(float(p) for p in prm), ptr(tpl), ptr(table),
              0 if table is None else table.shape[0])
    rc = _lib.lib().cross_caps(ctypes.byref(a), _lib.stream_ptr(dls))
    _lib.check(rc, "cross_caps")
    launches += 1
    launches_tpl += tpl is not None
    launches_app += ent_t is None
    return any_fail, ff_d, ff_foe
