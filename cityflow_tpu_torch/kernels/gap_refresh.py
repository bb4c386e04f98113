"""R6 gap_refresh: the lane-change step's stale-gap refresh, every lane and
link slot in one launch (csrc/gap_refresh.cu).

The end of the previous step's Vehicle::updateLeaderAndGap
(engine.cpp:581): a slot s > 0 takes the fresh gap to its leader in slot
s - 1, (lead_dis - lead_len) - dis; a lane front takes the gap to its
out-link leader (R5's best_*), else, within the leader-scan bound, to its
next link's end-lane tail, else keeps its stale gap; a link front takes
the gap to its end-lane tail when there is one. With templates the
leader's length and the front's maxSpeed / usualNegAcc (for the bound)
come from the template table.

Inputs: the rings (l_dis, l_gap, l_nxt [, l_tpl]) (SL, LNp, B) and
(k_dis, k_gap [, k_tpl]) (SK, LKp, B), and fx, R5's lane-change front
context. Returns (l_gap, k_gap), new tensors.
"""

import ctypes

import torch

from cityflow_tpu_torch.compiler.net import P_LEN, P_MAXSPEED, P_USUALNEGACC
from cityflow_tpu_torch.core.numerics import shift_in
from cityflow_tpu_torch.core.step import leader_scan_bound
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels.tpl_params import tpl_params_plain

launches = 0
launches_tpl = 0       # of those, with non-uniform templates
F32 = torch.float32
I32 = torch.int32
B8 = torch.bool

_FX = ("best_ex", "best_val", "ete", "nlen", "etd", "etl", "k_ete", "k_etd",
       "k_etl")
_PTRS = ("l_dis", "l_gap", "l_nxt", "l_tpl", "k_dis", "k_gap", "k_tpl",
         "ln_len", "lk_len", "table") + _FX + ("out_l", "out_k")


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] \
        + [(n, ctypes.c_longlong) for n in ("SL", "LNp", "SK", "LKp", "B",
                                            "TP")] \
        + [(n, ctypes.c_float) for n in ("p_len", "bound", "dt")]


def gap_refresh_plain(cfg, net, rs, fx):
    """Plain PyTorch version (ring_lc.refresh_gaps as it stood, JAX
    ring_lc.py:99-158)."""
    p = cfg.params
    LNp, B = rs.n_l.shape
    LKp = rs.n_k.shape[0]
    dev = rs.n_l.device
    if cfg.uniform:
        lead_len = klead_len = etl0 = k_etl = p[P_LEN]
        bound = leader_scan_bound(p[P_MAXSPEED], p[P_USUALNEGACC],
                                  cfg.interval)
    else:
        tp = net["tpl_params"]
        len_l, ms_l, una_l = tpl_params_plain(
            rs.l_tpl, tp, (P_LEN, P_MAXSPEED, P_USUALNEGACC))
        len_k = tpl_params_plain(rs.k_tpl, tp, (P_LEN,))[0]
        # the leader of slot s is slot s - 1
        lead_len = shift_in(torch.zeros((1, LNp, B), device=dev), len_l)
        klead_len = shift_in(torch.zeros((1, LKp, B), device=dev), len_k)
        etl0, k_etl = fx["etl"], fx["k_etl"]
        bound = leader_scan_bound(ms_l[0], una_l[0], cfg.interval)
    # lanes: slots > 0 always have the slot above as leader
    lead_dis = shift_in(torch.full((1, LNp, B), 1e9, device=dev), rs.l_dis)
    fresh_mid = lead_dis - lead_len - rs.l_dis
    lane_left0 = net["ln_len"][:, None] - rs.l_dis[0]
    # fronts: hop 1 = all out-link ring tails of my lane (strict-min), hop
    # 2 = my next link's end-lane tail, only within the scan bound
    has_next = rs.l_nxt[0] >= 0
    fresh1 = has_next & fx["best_ex"]
    g1 = lane_left0 + fx["best_val"]
    fresh2 = has_next & ~fx["best_ex"] & fx["ete"] \
        & (lane_left0 + fx["nlen"] <= bound)
    g2 = lane_left0 + fx["nlen"] + fx["etd"] - etl0
    gap0 = torch.where(fresh1, g1, torch.where(fresh2, g2, rs.l_gap[0]))
    new_l_gap = torch.cat([gap0[None], fresh_mid[1:]])
    # links: slots > 0 fresh; the front fresh iff the end-lane tail exists
    klead = shift_in(torch.full((1, LKp, B), 1e9, device=dev), rs.k_dis)
    kfresh = klead - klead_len - rs.k_dis
    kgap0 = torch.where(fx["k_ete"], (net["lk_len"][:, None] - rs.k_dis[0])
                        + fx["k_etd"] - k_etl, rs.k_gap[0])
    new_k_gap = torch.cat([kgap0[None], kfresh[1:]])
    return new_l_gap, new_k_gap


def gap_refresh(cfg, net, rs, fx):
    """R6 on CUDA tensors, the plain version on CPU tensors."""
    SL, SK, LNp, LKp = cfg.SL, cfg.SK, cfg.LNp, cfg.LKp
    B = rs.n_l.shape[-1]
    cpu = rs.n_l.device.type == "cpu"
    uni = cfg.uniform
    fxs = [fx[k] if uni is False or k not in ("etl", "k_etl") else None
           for k in _FX]
    fdt = [(B8,), (F32,), (B8,), (F32,), (F32,), (F32,), (B8,), (F32,),
           (F32,)]
    _lib.check_args("gap_refresh", rs.l_dis, rs.l_gap, rs.l_nxt, rs.l_tpl,
                    rs.k_dis, rs.k_gap, rs.k_tpl, *fxs,
                    dtypes=[(F32,), (F32,), (I32,), (I32,), (F32,), (F32,),
                            (I32,)] + fdt, cuda=not cpu)
    for t in (rs.l_dis, rs.l_gap, rs.l_nxt, rs.l_tpl):
        if t is not None and tuple(t.shape) != (SL, LNp, B):
            raise ValueError(f"gap_refresh: lane ring {tuple(t.shape)}")
    for t in (rs.k_dis, rs.k_gap, rs.k_tpl):
        if t is not None and tuple(t.shape) != (SK, LKp, B):
            raise ValueError(f"gap_refresh: link ring {tuple(t.shape)}")
    for k, t in zip(_FX, fxs):
        want = (LKp, B) if k.startswith("k_") else (LNp, B)
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"gap_refresh: fx {k} {tuple(t.shape)}")
    if (rs.l_tpl is None) != uni or (rs.k_tpl is None) != uni:
        raise ValueError("gap_refresh: template rings and cfg.uniform "
                         "disagree")
    if cpu:
        return gap_refresh_plain(cfg, net, rs, fx)
    return _launch(cfg, net, rs, dict(zip(_FX, fxs)))


def _launch(cfg, net, rs, fx):
    global launches, launches_tpl
    p = cfg.params
    uni = cfg.uniform
    out_l = torch.empty_like(rs.l_gap)
    out_k = torch.empty_like(rs.k_gap)
    ptrs = dict(l_dis=rs.l_dis, l_gap=rs.l_gap, l_nxt=rs.l_nxt,
                l_tpl=rs.l_tpl, k_dis=rs.k_dis, k_gap=rs.k_gap,
                k_tpl=rs.k_tpl, ln_len=net["ln_len"], lk_len=net["lk_len"],
                table=None if uni else net["tpl_params"], out_l=out_l,
                out_k=out_k, **fx)
    bound = leader_scan_bound(p[P_MAXSPEED], p[P_USUALNEGACC],
                              cfg.interval) if uni else 0.0
    a = _Args(*(None if ptrs[n] is None else ptrs[n].data_ptr()
                for n in _PTRS),
              cfg.SL, cfg.LNp, cfg.SK, cfg.LKp, rs.n_l.shape[-1],
              1 if uni else net["tpl_params"].shape[0],
              float(p[P_LEN]) if uni else 0.0, float(bound),
              float(cfg.interval))
    _lib.check(_lib.lib().gap_refresh(ctypes.byref(a),
                                      _lib.stream_ptr(out_l)),
               "gap_refresh")
    launches += 1
    launches_tpl += int(not uni)
    return out_l, out_k
