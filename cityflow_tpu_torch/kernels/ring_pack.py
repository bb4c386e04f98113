"""R7 ring_pack: the ring step's channel packs, each written straight from
the ring leaves into the buffer the next kernel reads
(csrc/ring_pack.cu). Four modes:

  forward (pack_forward)        the AP lane-front slots' channels of each
      in-lane's lane (through in_src), then its length and maxSpeed: the
      in-lane view `inl` (NFC * AP + 2, IL * G, B) that K2 / K3 / R5 and
      the commit read, 0 where in_src < 0.
  entrant (pack_entrants)       the lane fronts that leave into their next
      link this step, per link and front slot (to_link): ent (AP, NE,
      LKp, B), K4's link-ring append.
  candidate (pack_candidates)   the link-ring exit slots with their route
      rows, per lane row and in-lane (app_src_g): cands (KIN * XKe, NP,
      OL * G, B), K4's lane-ring append.
  approach (pack_approach)      the lane fronts that head into each link
      (to_link), per front slot and link: the approach rows' K2 / K3
      inputs (mine, speed, priority halves, dls, lane_left; with templates
      the template index, the approach distance and canEnter, read from
      the template table in place), each (AP, LKp, B).

Integer channels ride as float32 (int -> float rounding, as .to(float32)
gives) and come back through the saturating cast; priorities as their
16-bit halves (ring._hilo). A missing source writes +0.0 in every
channel.
"""

import ctypes

import torch

from cityflow_tpu_torch.compiler.net import (
    P_LEN, P_MAXSPEED, P_USUALNEGACC)
from cityflow_tpu_torch.core.numerics import xla_f32_to_i32
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels._ring_idx import (
    hilo as _hilo, lpi_of, to_link_idx)
from cityflow_tpu_torch.kernels.gather_rows import gather_rows_plain
from cityflow_tpu_torch.kernels.tpl_params import tpl_params_plain

launches = 0
launches_ent = 0        # of those, the entrant mode
launches_cand = 0       # of those, the candidate mode
launches_app = 0        # of those, the approach mode
F32 = torch.float32
I32 = torch.int32
B8 = torch.bool

_PTRS = ("l_dis", "l_speed", "l_nxt", "l_nxt3", "l_route", "l_rpos",
         "l_flow", "l_pri", "l_uid", "l_enter", "l_custom", "l_hascustom",
         "l_gap", "l_yv", "l_tpl", "n_l", "ln_len", "ln_maxspd", "in_src",
         "inl", "inl_in", "start_src", "exited", "ap_dis", "ap_spd",
         "new_dis_l", "new_spd_l", "ent", "nd_k", "ns_k", "k_flow",
         "k_route", "k_rpos", "k_enter", "k_pri", "k_uid", "k_gap", "k_tpl",
         "pays", "exit_flags", "lk_len", "app_src", "cands", "st_len", "et",
         "table", "ap_mine", "ap_f", "ap_tpl", "ap_ce")
_DIMS = ("SL", "LNp", "LKp", "IL", "G", "AP", "B", "XKl", "KIN", "XKe",
         "OLG", "MAXLPR", "nfc", "ch_tpl", "TP")
# the approach mode's float outputs, in ap_f's channel order
APPROACH_F = ("speed", "prih", "pril", "dls", "lane_left", "approach")


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] \
        + [(n, ctypes.c_longlong) for n in _DIMS] \
        + [("lc", ctypes.c_int), ("tpl", ctypes.c_int),
           ("dt", ctypes.c_float)]


def forward_channels(cfg):
    """The per-slot channels of `inl` (NFC), in order."""
    return (["dis", "speed", "nxt", "nxt3", "route", "rpos", "flow", "prih",
             "pril", "uid", "enter", "custom", "hascustom", "occ"]
            + (["gap", "yv"] if cfg.lane_change else [])
            + ([] if cfg.uniform else ["tpl"]))


def entrant_channels(cfg):
    return (["valid", "dis", "speed", "flow", "route", "rpos", "enter",
             "prih", "pril", "uid", "nxtl"]
            + (["gap"] if cfg.lane_change else [])
            + ([] if cfg.uniform else ["tpl"]))


def candidate_channels(cfg, MAXLPR):
    return (["dis", "speed", "flow", "route", "rpos", "enter", "prih",
             "pril", "uid", "nxt", "nxt3", "last", "prev", "valid"]
            + (["gap", "zero"] + [f"{k}{c}" for k in ("rn", "ax")
                                  for c in range(MAXLPR)]
               if cfg.lane_change else [])
            + ([] if cfg.uniform else ["tpl"]))


# ---------------------------------------------------------------------------
# plain versions (the packs as they stood inline in core/ring.py)
# ---------------------------------------------------------------------------

def pack_forward_plain(cfg, net, rs):
    """JAX ring.py:686-729: the lane-front bundles -> the in-lane view."""
    AP, LNp = cfg.AP, cfg.LNp
    B = rs.n_l.shape[-1]
    occ = torch.arange(AP, device=rs.n_l.device)[:, None, None] < rs.n_l[None]
    prih_l, pril_l = _hilo(rs.l_pri[:AP])
    fch = [rs.l_dis[:AP], rs.l_speed[:AP],
           rs.l_nxt[:AP].to(F32), rs.l_nxt3[:AP].to(F32),
           rs.l_route[:AP].to(F32), rs.l_rpos[:AP].to(F32),
           rs.l_flow[:AP].to(F32), prih_l, pril_l,
           rs.l_uid[:AP].to(F32), rs.l_enter[:AP],
           rs.l_custom[:AP], rs.l_hascustom[:AP].to(F32), occ.to(F32)]
    if cfg.lane_change:
        fch += [rs.l_gap[:AP], rs.l_yv[:AP]]
    if not cfg.uniform:
        fch.append(rs.l_tpl[:AP].to(F32))
    NFC = len(fch)
    fwd = torch.cat([torch.stack(fch).reshape(NFC * AP, LNp, B),
                     net["ln_len"][None, :, None].expand(1, LNp, B),
                     net["ln_maxspd"][None, :, None].expand(1, LNp, B)])
    return gather_rows_plain(fwd, net["in_src"].reshape(-1), 0.0)


def pack_entrants_plain(cfg, net, inl, exited, ap_dis=None, ap_spd=None,
                        new_dis_l=None, new_spd_l=None):
    """JAX ring.py:1644-1690: the lane fronts that leave into their next
    link, per link."""
    IL, G, AP, LNp, LKp = cfg.IL, cfg.G, cfg.AP, cfg.LNp, cfg.LKp
    B = inl.shape[-1]
    dev = inl.device
    lc = cfg.lane_change
    in_src = net["in_src"].reshape(-1)
    src_ok = (in_src >= 0).reshape(IL, G)[None, :, :, None]
    NFC = (inl.shape[0] - 2) // AP
    ch = lambda c: inl[c * AP:(c + 1) * AP].reshape(AP, IL, G, B)
    h_nxt = xla_f32_to_i32(ch(2))
    h_occ = (ch(13) > 0) & src_ok
    il_len = inl[NFC * AP].reshape(IL, G, B)
    ex_cols = [exited[a].to(F32) if a < exited.shape[0]
               else torch.zeros((LNp, B), device=dev) for a in range(AP)]
    if lc:
        for a in range(AP):
            ex_cols += [new_dis_l[a], new_spd_l[a]]
    ex_in = gather_rows_plain(torch.stack(ex_cols), in_src, 0.0)
    names = entrant_channels(cfg)
    ent = torch.empty((AP, len(names), LKp, B), device=dev)
    f = lambda c: xla_f32_to_i32(ch(c)).to(F32)
    for a in range(AP):
        ex_a = (ex_in[a] > 0).reshape(IL, G, B) & h_occ[a]
        ok = ex_a & (h_nxt[a] >= 0)
        if lc:
            front = [ex_in[AP + 2 * a].reshape(IL, G, B) - il_len,
                     ex_in[AP + 2 * a + 1].reshape(IL, G, B)]
        else:
            front = [ap_dis[a] - il_len, ap_spd[a]]
        src = front + [f(6)[a], f(4)[a], f(5)[a], ch(10)[a], ch(7)[a],
                       ch(8)[a], f(9)[a], f(3)[a]]
        if lc:
            src.append(ch(14)[a])             # stale controllerInfo.gap
        if not cfg.uniform:
            src.append(f(16 if lc else 14)[a])
        ent[a] = gather_rows_plain(torch.stack([ok.to(F32)] + [
            torch.where(ok, x, 0.0) for x in src]).reshape(
                len(names), IL * G, B),
            didx=to_link_idx(cfg, net, lpi_of(cfg, h_nxt[a])), fill=0.0)
    return ent


def pack_candidates_plain(cfg, net, rs, nd_k, ns_k, pays, exit_flags):
    """JAX ring.py:1744-1837: the link-ring exit slots with their route
    rows, per lane row and in-lane."""
    LNp, LKp = cfg.LNp, cfg.LKp
    XKe, _, B = exit_flags.shape
    dev = exit_flags.device
    lc = cfg.lane_change
    MAXLPR = (pays.shape[0] - 3) // 2
    names = candidate_channels(cfg, MAXLPR)
    pay_nxt, pay_nxt3, pay_last = pays[0], pays[1], pays[2] > 0
    prih_k, pril_k = _hilo(rs.k_pri[:XKe])
    prev = (LNp + torch.arange(LKp, device=dev)).to(F32)[:, None] \
        .expand(LKp, B)
    A = cfg.KIN * XKe
    cands = torch.empty((A, len(names), cfg.OL * cfg.G, B), device=dev)
    for xs in range(XKe):
        payload = torch.stack([
            nd_k[xs] - net["lk_len"][:, None], ns_k[xs],
            rs.k_flow[xs].to(F32), rs.k_route[xs].to(F32),
            (rs.k_rpos[xs] + 1).to(F32), rs.k_enter[xs], prih_k[xs],
            pril_k[xs], rs.k_uid[xs].to(F32), pay_nxt[xs].to(F32),
            pay_nxt3[xs].to(F32), pay_last[xs].to(F32), prev,
            exit_flags[xs].to(F32)]
            + ([] if not lc else [rs.k_gap[xs], torch.zeros_like(prev)]
               + [pays[3 + c][xs].to(F32) for c in range(2 * MAXLPR)])
            + ([] if cfg.uniform else [rs.k_tpl[xs].to(F32)]))
        for kin in range(cfg.KIN):
            cands[kin * XKe + xs] = gather_rows_plain(
                payload, net["app_src_g"][kin], 0.0)
    return cands


def pack_approach_plain(cfg, net, inl, st, et=None):
    """JAX ring.py:1154-1168, :1206-1231: each lane-front slot's channels
    routed to its next link (to_link), then the approach rows' K2 / K3
    inputs; with templates their parameters (_PP) and canEnter of the
    link's end lane (et: the end-lane tail bundle) for the front's own
    length."""
    IL, G, AP, LKp = cfg.IL, cfg.G, cfg.AP, cfg.LKp
    B = inl.shape[-1]
    uni = cfg.uniform
    src_ok = (net["in_src"].reshape(-1) >= 0).reshape(IL, G)[None, :, :,
                                                              None]
    ch = lambda c: inl[c * AP:(c + 1) * AP].reshape(AP, IL, G, B)
    h_nxt = xla_f32_to_i32(ch(2))
    h_occ = (ch(13) > 0) & src_ok
    if not uni:
        h_tpl = xla_f32_to_i32(ch(forward_channels(cfg).index("tpl")))
    NLC = 5 if uni else 6
    lk_ch = torch.stack([gather_rows_plain(
        torch.stack([(h_occ[a] & (h_nxt[a] >= 0)).to(F32), ch(0)[a],
                     ch(1)[a], ch(7)[a], ch(8)[a]]
                    + ([] if uni else [h_tpl[a].to(F32)]))
        .reshape(NLC, IL * G, B),
        didx=to_link_idx(cfg, net, lpi_of(cfg, h_nxt[a])), fill=0.0)
        for a in range(AP)])                            # (AP, NLC, LKp, B)
    st_len = st[6]
    dis = lk_ch[:, 1]
    out = dict(mine=lk_ch[:, 0] > 0.5, speed=lk_ch[:, 2].contiguous(),
               prih=lk_ch[:, 3].contiguous(), pril=lk_ch[:, 4].contiguous(),
               dls=dis - st_len[None], lane_left=st_len[None] - dis)
    if not uni:
        table = net["tpl_params"]
        tpl = xla_f32_to_i32(lk_ch[:, 5]).contiguous()
        ln, ms, una = tpl_params_plain(tpl, table,
                                       (P_LEN, P_MAXSPEED, P_USUALNEGACC))
        dt = net["ring_f32"][len(cfg.params)]
        et_len = tpl_params_plain(xla_f32_to_i32(et[6]), table, (P_LEN,))[0]
        out.update(tpl=tpl, approach=ms * ms / una / 2 + ms * dt * 2,
                   ce=~(et[5] > 0.5) | (et[0] > et_len + ln) | (et[2] >= 2))
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_LANE = ("l_dis", "l_speed", "l_nxt", "l_nxt3", "l_route", "l_rpos",
         "l_flow", "l_pri", "l_uid", "l_enter", "l_custom", "l_hascustom",
         "l_gap", "l_yv", "l_tpl")
_LINK = ("k_flow", "k_route", "k_rpos", "k_enter", "k_pri", "k_uid",
         "k_gap", "k_tpl")
_DT = dict(l_dis=F32, l_speed=F32, l_enter=F32, l_custom=F32, l_gap=F32,
           l_yv=F32, l_hascustom=B8, k_enter=F32, k_gap=F32)


def _leaves(rs, names, shape, cpu, name):
    ts = [getattr(rs, n) for n in names]
    _lib.check_args(name, *ts, dtypes=[(_DT.get(n, I32),) for n in names],
                    cuda=not cpu)
    for n, t in zip(names, ts):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {n} {tuple(t.shape)}")
    return ts


def _check_lc_tpl(cfg, rs, name, lane):
    pre = "l_" if lane else "k_"
    if (getattr(rs, pre + "gap") is None) == cfg.lane_change \
            or (lane and (rs.l_yv is None) == cfg.lane_change) \
            or (getattr(rs, pre + "tpl") is None) != cfg.uniform:
        raise ValueError(f"{name}: lane-change / template leaves and the "
                         "config disagree")


def _args(cfg, net, B, **ptrs):
    ptr = lambda t: None if t is None else t.data_ptr()
    table = ptrs.get("table")
    return _Args(*(ptr(ptrs.get(n)) for n in _PTRS),
                 cfg.SL, cfg.LNp, cfg.LKp, cfg.IL, cfg.G, cfg.AP, B,
                 ptrs.get("XKl", 0), cfg.KIN, ptrs.get("XKe", 0),
                 cfg.OL * cfg.G, ptrs.get("MAXLPR", 0),
                 len(forward_channels(cfg)),
                 16 if cfg.lane_change else 14,
                 0 if table is None else table.shape[0],
                 int(cfg.lane_change), int(not cfg.uniform), cfg.interval)


def pack_forward(cfg, net, rs):
    """R7's forward mode on CUDA tensors, the plain version on CPU tensors.
    Returns inl (NFC * AP + 2, IL * G, B) float32."""
    B = rs.n_l.shape[-1]
    cpu = rs.n_l.device.type == "cpu"
    ts = _leaves(rs, _LANE, (cfg.SL, cfg.LNp, B), cpu, "pack_forward")
    _lib.check_args("pack_forward", rs.n_l, *ts, dtypes=[(I32,)] + [None] *
                    len(ts), cuda=not cpu)
    _check_lc_tpl(cfg, rs, "pack_forward", True)
    if cpu:
        return pack_forward_plain(cfg, net, rs)
    global launches
    NFC = len(forward_channels(cfg))
    inl = torch.empty((NFC * cfg.AP + 2, cfg.IL * cfg.G, B), dtype=F32,
                      device=rs.n_l.device)
    a = _args(cfg, net, B, **dict(zip(_LANE, ts)), n_l=rs.n_l,
              ln_len=net["ln_len"], ln_maxspd=net["ln_maxspd"],
              in_src=net["in_src"], inl=inl)
    _lib.check(_lib.lib().ring_pack(ctypes.byref(a), 0, _lib.stream_ptr(inl)),
               "pack_forward")
    launches += 1
    return inl


def pack_entrants(cfg, net, inl, exited, ap_dis=None, ap_spd=None,
                  new_dis_l=None, new_spd_l=None):
    """R7's entrant mode on CUDA tensors, the plain version on CPU tensors.
    `exited` (XKl, LNp, B) bool; without lane change the approach rows'
    ap_dis / ap_spd (AP, IL, G, B), with it the lane rows' final
    new_dis_l / new_spd_l (SL, LNp, B). Returns ent (AP, NE, LKp, B)."""
    AP, LNp, B = cfg.AP, cfg.LNp, inl.shape[-1]
    cpu = inl.device.type == "cpu"
    lc = cfg.lane_change
    fr = (new_dis_l, new_spd_l) if lc else (ap_dis, ap_spd)
    _lib.check_args("pack_entrants", inl, exited, *fr,
                    dtypes=[(F32,), (B8,), (F32,), (F32,)], cuda=not cpu)
    NFC = len(forward_channels(cfg))
    if any(t is None for t in fr) \
            or tuple(inl.shape) != (NFC * AP + 2, cfg.IL * cfg.G, B) \
            or exited.dim() != 3 or tuple(exited.shape[1:]) != (LNp, B) \
            or any(t.numel() != (cfg.SL * LNp * B if lc
                                 else AP * cfg.IL * cfg.G * B) for t in fr):
        raise ValueError("pack_entrants: input shapes")
    if cpu:
        return pack_entrants_plain(cfg, net, inl, exited, ap_dis, ap_spd,
                                   new_dis_l, new_spd_l)
    global launches, launches_ent
    ent = torch.empty((AP, len(entrant_channels(cfg)), cfg.LKp, B),
                      dtype=F32, device=inl.device)
    a = _args(cfg, net, B, inl_in=inl, in_src=net["in_src"],
              start_src=net["start_src"], exited=exited, ap_dis=ap_dis,
              ap_spd=ap_spd, new_dis_l=new_dis_l, new_spd_l=new_spd_l,
              ent=ent, XKl=exited.shape[0])
    _lib.check(_lib.lib().ring_pack(ctypes.byref(a), 1, _lib.stream_ptr(ent)),
               "pack_entrants")
    launches += 1
    launches_ent += 1
    return ent


def pack_candidates(cfg, net, rs, nd_k, ns_k, pays, exit_flags):
    """R7's candidate mode on CUDA tensors, the plain version on CPU
    tensors. nd_k / ns_k (SK, LKp, B) the link rows' new distances and
    speeds, pays R4's route rows, exit_flags (XKe, LKp, B) bool. Returns
    cands (KIN * XKe, NP, OL * G, B)."""
    SK, LKp = cfg.SK, cfg.LKp
    B = rs.n_k.shape[-1]
    cpu = rs.n_k.device.type == "cpu"
    ts = _leaves(rs, _LINK, (SK, LKp, B), cpu, "pack_candidates")
    _check_lc_tpl(cfg, rs, "pack_candidates", False)
    _lib.check_args("pack_candidates", nd_k, ns_k, pays, exit_flags,
                    dtypes=[(F32,), (F32,), (I32,), (B8,)], cuda=not cpu)
    XKe = exit_flags.shape[0]
    MAXLPR = net["route_next"].shape[2]
    if tuple(nd_k.shape) != (SK, LKp, B) or tuple(ns_k.shape) != (SK, LKp, B) \
            or tuple(exit_flags.shape) != (XKe, LKp, B) or XKe > SK \
            or tuple(pays.shape) != (3 + 2 * MAXLPR * cfg.lane_change, XKe,
                                     LKp, B):
        raise ValueError("pack_candidates: input shapes")
    if cpu:
        return pack_candidates_plain(cfg, net, rs, nd_k, ns_k, pays,
                                     exit_flags)
    global launches, launches_cand
    cands = torch.empty((cfg.KIN * XKe, len(candidate_channels(cfg, MAXLPR)),
                         cfg.OL * cfg.G, B), dtype=F32, device=nd_k.device)
    a = _args(cfg, net, B, **dict(zip(_LINK, ts)), nd_k=nd_k, ns_k=ns_k,
              pays=pays, exit_flags=exit_flags, lk_len=net["lk_len"],
              app_src=net["app_src_g"], cands=cands, XKe=XKe, MAXLPR=MAXLPR)
    _lib.check(_lib.lib().ring_pack(ctypes.byref(a), 2,
                                    _lib.stream_ptr(cands)),
               "pack_candidates")
    launches += 1
    launches_cand += 1
    return cands


def pack_approach(cfg, net, inl, st, et=None):
    """R7's approach mode on CUDA tensors, the plain version on CPU
    tensors. `inl` the forward view (NFC * AP + 2, IL * G, B), `st` the
    start-lane head bundle (its channel 6 the start in-lane's length, (.,
    LKp, B)), `et` the end-lane tail bundle (templates only). Returns a
    dict of (AP, LKp, B) tensors: mine (bool), speed, prih, pril, dls,
    lane_left; with templates also tpl (int32), approach and ce (bool)."""
    AP, LKp, B = cfg.AP, cfg.LKp, inl.shape[-1]
    cpu = inl.device.type == "cpu"
    uni = cfg.uniform
    _lib.check_args("pack_approach", inl, st, et,
                    dtypes=[(F32,), (F32,), (F32,)], cuda=not cpu)
    NFC = len(forward_channels(cfg))
    if tuple(inl.shape) != (NFC * AP + 2, cfg.IL * cfg.G, B) \
            or st.dim() != 3 or st.shape[0] <= 6 \
            or tuple(st.shape[1:]) != (LKp, B) \
            or (et is None) != uni or (et is not None and (
                et.dim() != 3 or et.shape[0] <= 6
                or tuple(et.shape[1:]) != (LKp, B))):
        raise ValueError("pack_approach: input shapes")
    if cpu:
        return pack_approach_plain(cfg, net, inl, st, et)
    global launches, launches_app
    dev = inl.device
    NF = 5 if uni else 6
    f = torch.empty((NF, AP, LKp, B), dtype=F32, device=dev)
    out = dict(mine=torch.empty((AP, LKp, B), dtype=B8, device=dev))
    out.update(zip(APPROACH_F[:NF], f))
    kw = {}
    if not uni:
        out.update(tpl=torch.empty((AP, LKp, B), dtype=I32, device=dev),
                   ce=torch.empty((AP, LKp, B), dtype=B8, device=dev))
        kw = dict(et=et, table=net["tpl_params"], ap_tpl=out["tpl"],
                  ap_ce=out["ce"])
    a = _args(cfg, net, B, inl_in=inl, in_src=net["in_src"],
              start_src=net["start_src"], st_len=st[6], ap_mine=out["mine"],
              ap_f=f, **kw)
    _lib.check(_lib.lib().ring_pack(ctypes.byref(a), 3, _lib.stream_ptr(inl)),
               "pack_approach")
    launches += 1
    launches_app += 1
    return out
