"""R5 front_leaders: the leaders of the lane fronts, read from the link
rings (csrc/front_leaders.cu).

A lane front's leader lies past its lane's end: first the nearest ring
tail over the in-lane's KOUT out-links (Lane::laneLinks order, a strict
min, the first k winning a tie, vehicle.cpp:170-180), else its next
link's end-lane tail. The kernel reads each out-link's ring tail in place
through net["out_src"], so the (C, IL, KOUT, G, B) candidate slab of the
plain version is never written. Two modes:

  approach (front_leaders)   every ring path: per front slot a < AP of
      each in-lane, K3's approach min_chain inputs: gap, lead_spd,
      has_lead, lane_left, lead_tpl (templates), and v_isr / isr_rel read
      back from the slot's next link. The min compares kt_dis - len (the
      length subtracted before the compare); slot a > 0's leader is slot
      a - 1 of the in-lane.
  lc (front_leaders_lc)      the lane-change paths, two launches (links,
      then lanes): lc_front_ctx's dict, each entry on the axis its
      consumers (L1, R3, R6) read. The min compares the raw dis and
      subtracts the length after (uniform); with templates dis - len.

Inputs are the link rings k_dis / k_speed / k_tpl (SK, LKp, B) and n_k,
and for the approach mode the forward exchange `inl` (R7's output), the
end-lane tail bundle `et` ((CE, LKp, B): dis, prev, speed, pri hi, pri
lo, exists [, tpl]) and the link-domain isr rows v_isr_ap / isr_rel_ap
(AP, LPI, G, B). A missing source reads +0.0, as the plain gathers' fill.
"""

import ctypes

import torch

from cityflow_tpu_torch.compiler.net import P_LEN
from cityflow_tpu_torch.core.numerics import xla_f32_to_i32
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels._ring_idx import (
    from_link_idx, lpi_of, sel_slot as _sel_slot)
from cityflow_tpu_torch.kernels.gather_rows import gather_rows_plain
from cityflow_tpu_torch.kernels.tpl_params import tpl_params_plain

launches = 0
launches_ctx = 0       # of those, the lane-change mode (two launches a call)
F32 = torch.float32
I32 = torch.int32
B8 = torch.bool

APPROACH_OUT = ("gap", "lead_spd", "has_lead", "lane_left", "v_isr",
                "isr_rel", "lead_tpl")
_PTRS = ("k_dis", "k_speed", "k_tpl", "n_k", "l_dis", "l_tpl", "l_nxt",
         "n_l", "out_src", "out_valid", "in_src", "in_inv", "end_src",
         "lk_len", "table", "inl", "et", "v_isr_ap", "isr_rel_ap", "gap",
         "lead_spd", "has_lead", "lane_left", "v_isr", "isr_rel", "lead_tpl",
         "k_etd", "k_ete", "k_etl", "best_val", "best_ex", "nlen", "etd",
         "ete", "etl", "olt_dis", "olt_ex", "olt_len")
_DIMS = ("SK", "SL", "LKp", "LNp", "IL", "G", "KOUT", "LPI", "AP", "B", "TP",
         "ch_tpl", "nfc")


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] \
        + [(n, ctypes.c_longlong) for n in _DIMS] + [("p_len", ctypes.c_float)]


def _len(tpl, table):
    return tpl_params_plain(tpl, table, (P_LEN,))[0]


def _inl_channels(cfg, inl):
    """(nfc, tpl channel) of the forward exchange."""
    return (inl.shape[0] - 2) // cfg.AP, 16 if cfg.lane_change else 14


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def front_leaders_plain(cfg, net, rs, inl, et, v_isr_ap, isr_rel_ap):
    """Plain PyTorch version (the approach rows' KOUT min and per-front
    leaders as they stood inline in core/ring.py, JAX ring.py:1151-1300)."""
    IL, G, AP, LPI, KOUT = cfg.IL, cfg.G, cfg.AP, cfg.LPI, cfg.KOUT
    B = inl.shape[-1]
    uni = cfg.uniform
    table = net["tpl_params"]
    p_len = cfg.params[P_LEN]
    nfc, ch_tpl = _inl_channels(cfg, inl)
    ch = lambda c: inl[c * AP:(c + 1) * AP].reshape(AP, IL, G, B)
    h_dis, h_speed = ch(0), ch(1)
    h_nxt = xla_f32_to_i32(ch(2))
    src_ok = (net["in_src"].reshape(-1) >= 0).reshape(IL, G)[None, :, :, None]
    h_occ = (ch(13) > 0) & src_ok
    il_len = inl[nfc * AP].reshape(IL, G, B)
    h_tpl = None if uni else xla_f32_to_i32(ch(ch_tpl))
    # hop 1: ring tails of all out-links, strict min on dis - len
    kt_dis = _sel_slot(rs.k_dis, rs.n_k)
    kt_speed = _sel_slot(rs.k_speed, rs.n_k)
    kt_exists = rs.n_k > 0
    if uni:
        oc_in = [kt_dis - p_len, kt_exists.to(F32), kt_speed]
    else:
        kt_tpl = _sel_slot(rs.k_tpl, rs.n_k)
        oc_in = [kt_dis - _len(kt_tpl, table), kt_exists.to(F32), kt_speed,
                 kt_tpl.to(F32)]
    oc = gather_rows_plain(torch.stack(oc_in), net["out_src"], 0.0) \
        .reshape(len(oc_in), IL, KOUT, G, B)
    oc_valid = net["out_valid_g"][..., None] > 0             # (IL,KOUT,G,1)
    best_val = torch.zeros((IL, G, B), device=inl.device)
    best_spd = torch.zeros((IL, G, B), device=inl.device)
    best_ex = torch.zeros((IL, G, B), dtype=B8, device=inl.device)
    best_tpl = torch.zeros((IL, G, B), device=inl.device)
    for k in range(KOUT):
        cand_ex = (oc[1, :, k] > 0.5) & oc_valid[:, k]
        better = cand_ex & (~best_ex | (oc[0, :, k] < best_val))
        best_val = torch.where(better, oc[0, :, k], best_val)
        best_spd = torch.where(better, oc[2, :, k], best_spd)
        if not uni:
            best_tpl = torch.where(better, oc[3, :, k], best_tpl)
        best_ex = best_ex | cand_ex
    # the end-lane tail of each link
    et4 = et.reshape(et.shape[0], LPI, G, B)
    end_tail_tpl = None if uni else xla_f32_to_i32(et4[6])
    lk_len = net["lk_len"].reshape(LPI, G, 1)
    if not uni:
        h_len = _len(h_tpl, table)                           # (AP, IL, G, B)
    gl, ll, lsp, hl, vi, ir, lt = [], [], [], [], [], [], []
    for a in range(AP):
        fidx = from_link_idx(cfg, lpi_of(cfg, h_nxt[a]))
        if a == 0:
            bk_in = [v_isr_ap[0], isr_rel_ap[0].to(F32), et4[0],
                     (et4[5] > 0.5).to(F32), et4[2],
                     lk_len.expand(LPI, G, B)]
            if not uni:
                bk_in.append(end_tail_tpl.to(F32))
            bk = gather_rows_plain(
                torch.stack(bk_in).reshape(len(bk_in), cfg.LKp, B),
                didx=fidx, fill=0.0).reshape(len(bk_in), IL, G, B)
            etd, ete, ets, nlen = bk[2], bk[3] > 0.5, bk[4], bk[5]
            lane_left_a = il_len - h_dis[0]
            gap1 = lane_left_a + best_val
            if uni:
                gap2 = lane_left_a + nlen + etd - p_len
            else:
                # hop 2: the next link's end-lane tail, with its len
                et_tpl_a = xla_f32_to_i32(bk[6])
                gap2 = lane_left_a + nlen + etd - _len(et_tpl_a, table)
                lt.append(torch.where(best_ex, xla_f32_to_i32(best_tpl),
                                      et_tpl_a))
            hl.append(best_ex | ete)
            gl.append(torch.where(best_ex, gap1, gap2))
            lsp.append(torch.where(best_ex, best_spd, ets))
        else:
            bk = gather_rows_plain(torch.stack([
                v_isr_ap[a], isr_rel_ap[a].to(F32)]).reshape(2, cfg.LKp, B),
                didx=fidx, fill=0.0).reshape(2, IL, G, B)
            hl.append(h_occ[a - 1])
            gl.append(h_dis[a - 1] - (p_len if uni else h_len[a - 1])
                      - h_dis[a])
            lsp.append(h_speed[a - 1])
            if not uni:
                lt.append(h_tpl[a - 1])
        vi.append(bk[0])
        ir.append(bk[1] > 0.5)
        ll.append(il_len - h_dis[a])
    out = dict(gap=torch.stack(gl), lead_spd=torch.stack(lsp),
               has_lead=torch.stack(hl), lane_left=torch.stack(ll),
               v_isr=torch.stack(vi), isr_rel=torch.stack(ir))
    if not uni:
        out["lead_tpl"] = torch.stack(lt)
    return out


def _kout_min_lc(oc, oc_valid, uni):
    """The lane-change site's strict min (first wins) over the KOUT
    out-link ring tails: on the raw dis (uniform; the length is subtracted
    after) or on dis - len. Returns (best_ex, best_raw), (IL, G, B) each."""
    _, IL, KOUT, G, B = oc.shape
    best_ex = torch.zeros((IL, G, B), dtype=B8, device=oc.device)
    best_raw = torch.zeros((IL, G, B), device=oc.device)
    for k in range(KOUT):
        cand_ex = (oc[1, :, k] > 0.5) & oc_valid[:, k]
        v = oc[0, :, k] if uni else oc[0, :, k] - oc[2, :, k]
        better = cand_ex & (~best_ex | (v < best_raw))
        best_raw = torch.where(better, v, best_raw)
        best_ex = best_ex | cand_ex
    return best_ex, best_raw


def front_leaders_lc_plain(cfg, net, rs):
    """Plain PyTorch version (lc_front_ctx as it stood in core/ring.py,
    JAX ring.py:344-448)."""
    LKp, IL, G, KOUT = cfg.LKp, cfg.IL, cfg.G, cfg.KOUT
    B = rs.n_l.shape[-1]
    uni = cfg.uniform
    table = net["tpl_params"]
    p_len = cfg.params[P_LEN]
    # lane tails -> per-link end-lane tails (E_end)
    et_in = [_sel_slot(rs.l_dis, rs.n_l), (rs.n_l > 0).to(F32)]
    if not uni:
        et_in.append(_len(_sel_slot(rs.l_tpl, rs.n_l), table))
    et = gather_rows_plain(torch.stack(et_in), net["end_src"], 0.0)
    etd_lk, ete_lk = et[0], et[1] > 0.5
    # link ring tails -> per-in-lane out-link candidates (E_out)
    oc_in = [_sel_slot(rs.k_dis, rs.n_k), (rs.n_k > 0).to(F32)]
    if not uni:
        oc_in.append(_len(_sel_slot(rs.k_tpl, rs.n_k), table))
    oc = gather_rows_plain(torch.stack(oc_in), net["out_src"],
                           0.0).reshape(len(oc_in), IL, KOUT, G, B)
    oc_valid = net["out_valid_g"][..., None] > 0
    best_ex, best_raw = _kout_min_lc(oc, oc_valid, uni)
    # the front vehicle's next link: its length and end-lane tail
    nxt_ilg = xla_f32_to_i32(gather_rows_plain(
        rs.l_nxt[0].to(F32)[None], net["in_src"].reshape(-1), 0.0)[0]) \
        .reshape(IL, G, B)
    fl_in = [net["lk_len"][:, None].expand(LKp, B), etd_lk, ete_lk.to(F32)]
    if not uni:
        fl_in.append(et[2])
    fl = gather_rows_plain(torch.stack(fl_in),
                           didx=from_link_idx(cfg, lpi_of(cfg, nxt_ilg)),
                           fill=0.0)
    # back to the lane axis
    ch = [best_raw - p_len if uni else best_raw, best_ex.to(F32), fl[0],
          fl[1], fl[2]]
    for k in range(KOUT):
        ch.append(oc[0, :, k])
        ch.append((oc[1, :, k] > 0.5).to(F32) * oc_valid[:, k].to(F32))
    if not uni:
        ch.append(fl[3])                        # end-tail length
        ch += [oc[2, :, k] for k in range(KOUT)]  # candidate lengths
    lane = gather_rows_plain(torch.stack([c.reshape(IL * G, B) for c in ch]),
                             net["in_inv"], 0.0)
    out = dict(best_val=lane[0], best_ex=lane[1] > 0.5, nlen=lane[2],
               etd=lane[3], ete=lane[4] > 0.5,
               olt_dis=lane[5:5 + 2 * KOUT:2].contiguous(),
               olt_ex=lane[6:6 + 2 * KOUT:2] > 0.5, k_etd=etd_lk,
               k_ete=ete_lk)
    if not uni:
        base = 5 + 2 * KOUT
        out.update(etl=lane[base], olt_len=lane[base + 1:].contiguous(),
                   k_etl=et[2])
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, cfg, rs, lc, extra, extra_dt, cpu):
    SK, LKp, B = cfg.SK, cfg.LKp, rs.n_k.shape[-1]
    tens = [rs.k_dis, rs.k_speed, rs.n_k, rs.k_tpl]
    dts = [(F32,), (F32,), (I32,), (I32,)]
    if lc:
        tens += [rs.l_dis, rs.n_l, rs.l_nxt, rs.l_tpl]
        dts += [(F32,), (I32,), (I32,), (I32,)]
    _lib.check_args(name, *(tens + extra), dtypes=dts + extra_dt,
                    cuda=not cpu)
    for t in (rs.k_dis, rs.k_speed, rs.k_tpl):
        if t is not None and tuple(t.shape) != (SK, LKp, B):
            raise ValueError(f"{name}: link ring {tuple(t.shape)}")
    if (rs.k_tpl is None) != cfg.uniform or (
            lc and (rs.l_tpl is None) != cfg.uniform):
        raise ValueError(f"{name}: template rings and cfg.uniform disagree")


def front_leaders(cfg, net, rs, inl, et, v_isr_ap, isr_rel_ap):
    """R5's approach mode on CUDA tensors, the plain version on CPU
    tensors. Returns dict(gap, lead_spd, has_lead, lane_left, v_isr,
    isr_rel [, lead_tpl]), (AP, IL, G, B) each."""
    AP, LKp = cfg.AP, cfg.LKp
    B = inl.shape[-1]
    cpu = inl.device.type == "cpu"
    _check("front_leaders", cfg, rs, False,
           [inl, et, v_isr_ap, isr_rel_ap],
           [(F32,), (F32,), (F32,), (B8,)], cpu)
    nfc, _ = _inl_channels(cfg, inl)
    if tuple(inl.shape) != (nfc * AP + 2, cfg.IL * cfg.G, B) \
            or et.dim() != 3 or tuple(et.shape[1:]) != (LKp, B) \
            or et.shape[0] < (6 if cfg.uniform else 7) \
            or v_isr_ap.numel() != AP * LKp * B \
            or isr_rel_ap.numel() != AP * LKp * B:
        raise ValueError("front_leaders: input shapes")
    if cpu:
        return front_leaders_plain(cfg, net, rs, inl, et, v_isr_ap,
                                   isr_rel_ap)
    return _launch_approach(cfg, net, rs, inl, et, v_isr_ap, isr_rel_ap)


def front_leaders_lc(cfg, net, rs):
    """R5's lane-change mode on CUDA tensors, the plain version on CPU
    tensors: lc_front_ctx's dict (best_val, best_ex, nlen, etd, ete,
    olt_dis, olt_ex, k_etd, k_ete [, etl, olt_len, k_etl])."""
    cpu = rs.n_l.device.type == "cpu"
    _check("front_leaders_lc", cfg, rs, True, [], [], cpu)
    if tuple(rs.l_dis.shape) != (cfg.SL, cfg.LNp, rs.n_l.shape[-1]):
        raise ValueError(f"front_leaders_lc: lane ring "
                         f"{tuple(rs.l_dis.shape)}")
    if cpu:
        return front_leaders_lc_plain(cfg, net, rs)
    return _launch_lc(cfg, net, rs)


def _args(cfg, net, rs, B, **ptrs):
    ptr = lambda t: None if t is None else t.data_ptr()
    p = dict(k_dis=rs.k_dis, k_speed=rs.k_speed, k_tpl=rs.k_tpl, n_k=rs.n_k,
             out_src=net["out_src"], out_valid=net["out_valid_g"],
             in_src=net["in_src"], in_inv=net["in_inv"],
             end_src=net["end_src"], lk_len=net["lk_len"],
             table=None if cfg.uniform else net["tpl_params"])
    p.update(ptrs)
    return _Args(*(ptr(p.get(n)) for n in _PTRS),
                 cfg.SK, cfg.SL, cfg.LKp, cfg.LNp, cfg.IL, cfg.G, cfg.KOUT,
                 cfg.LPI, cfg.AP, B,
                 1 if cfg.uniform else net["tpl_params"].shape[0],
                 16 if cfg.lane_change else 14,
                 p.get("nfc", 0), float(cfg.params[P_LEN]))


def _launch_approach(cfg, net, rs, inl, et, v_isr_ap, isr_rel_ap):
    global launches
    B = inl.shape[-1]
    dev = inl.device
    shape = (cfg.AP, cfg.IL, cfg.G, B)
    out = {k: torch.empty(shape, dtype=B8 if k in ("has_lead", "isr_rel")
                          else I32 if k == "lead_tpl" else F32, device=dev)
           for k in APPROACH_OUT if k != "lead_tpl" or not cfg.uniform}
    nfc, _ = _inl_channels(cfg, inl)
    a = _args(cfg, net, rs, B, inl=inl, et=et, v_isr_ap=v_isr_ap,
              isr_rel_ap=isr_rel_ap, nfc=nfc, **out)
    _lib.check(_lib.lib().front_leaders(ctypes.byref(a), 0,
                                        _lib.stream_ptr(inl)),
               "front_leaders")
    launches += 1
    return out


def _launch_lc(cfg, net, rs):
    global launches, launches_ctx
    LNp, LKp, KOUT = cfg.LNp, cfg.LKp, cfg.KOUT
    B = rs.n_l.shape[-1]
    dev = rs.n_l.device
    e = lambda *s, dt=F32: torch.empty(s, dtype=dt, device=dev)
    out = dict(best_val=e(LNp, B), best_ex=e(LNp, B, dt=B8),
               nlen=e(LNp, B), etd=e(LNp, B), ete=e(LNp, B, dt=B8),
               olt_dis=e(KOUT, LNp, B), olt_ex=e(KOUT, LNp, B, dt=B8),
               k_etd=e(LKp, B), k_ete=e(LKp, B, dt=B8))
    if not cfg.uniform:
        out.update(etl=e(LNp, B), olt_len=e(KOUT, LNp, B), k_etl=e(LKp, B))
    a = _args(cfg, net, rs, B, l_dis=rs.l_dis, l_tpl=rs.l_tpl,
              l_nxt=rs.l_nxt, n_l=rs.n_l, **out)
    L, st = _lib.lib(), _lib.stream_ptr(rs.n_l)
    for mode in (1, 2):
        _lib.check(L.front_leaders(ctypes.byref(a), mode, st),
                   "front_leaders_lc")
    launches += 1
    launches_ctx += 1
    return out
