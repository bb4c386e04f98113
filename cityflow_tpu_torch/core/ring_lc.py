"""Lane change in the gen-2 ring layout, PyTorch port of the JAX package's
core/ring_lc.py (uniform vehicle templates).

The reference's signal/shadow protocol (src/vehicle/lanechange.{h,cpp},
engine.cpp:792-820) over per-lane ring slots, with the JAX version's
semantics: Jacobi arbitration, deterministic shadow priorities, LCI shadow
inserts per lane per step (overflow-flagged), route lookups for the target
lane from per-vehicle route-row bundles (l_rnrow / l_auxrow), the stale-gap
semantics of Vehicle::updateLeaderAndGap in the l_gap / k_gap channels.
Real and shadow share the uid; each finds its partner in the neighbour
lane column by uid match.

Where the JAX version permutes whole channel bundles to the inner / outer
neighbour column (_perm / perm_channels, a TPU shift plan), the kernels
here read the neighbour column in place by index (net["inner_src"] /
net["outer_src"]):

  refresh_gaps   plain PyTorch (an elementwise pass)
  lc_phase       L1 lc_signal -> L2 lc_receive -> L3 lc_insert
  partner_fetch  L4 lc_partner
"""

import torch

from cityflow_tpu_torch.compiler.net import (
    P_LEN, P_MAXNEGACC, P_MAXSPEED, P_USUALNEGACC)
from cityflow_tpu_torch.core.numerics import shift_in
from cityflow_tpu_torch.core.step import leader_scan_bound
from cityflow_tpu_torch.kernels.lc_insert import lc_insert
from cityflow_tpu_torch.kernels.lc_partner import lc_partner
from cityflow_tpu_torch.kernels.lc_receive import lc_receive
from cityflow_tpu_torch.kernels.lc_signal import lc_signal

# lane ring leaves handed to L3, by its channel names
_INSERT_LEAVES = {
    "dis": "l_dis", "speed": "l_speed", "flow": "l_flow", "route": "l_route",
    "rpos": "l_rpos", "nxt": "l_nxt", "nxt3": "l_nxt3", "prev": "l_prev",
    "enter": "l_enter", "pri": "l_pri", "uid": "l_uid", "last": "l_last",
    "gap": "l_gap", "dir": "l_dir", "off": "l_off", "sh": "l_sh",
    "chg": "l_chg", "custom": "l_custom", "hascustom": "l_hascustom",
    "rnrow": "l_rnrow", "auxrow": "l_auxrow"}


def refresh_gaps(net, cfg, rs, fx):
    """End-of-previous-step Vehicle::updateLeaderAndGap values
    (engine.cpp:581): a fresh gap where a leader exists within the scan
    bound, the previous (stale) value otherwise. fx = ring.lc_front_ctx."""
    p = cfg.params
    p_len = p[P_LEN]
    bound = leader_scan_bound(p[P_MAXSPEED], p[P_USUALNEGACC], cfg.interval)
    LNp, B = rs.n_l.shape
    LKp = rs.n_k.shape[0]
    dev = rs.n_l.device
    # lanes: slots > 0 always have the slot above as leader
    lead_dis = shift_in(torch.full((1, LNp, B), 1e9, device=dev), rs.l_dis)
    fresh_mid = lead_dis - p_len - rs.l_dis
    lane_left0 = net["ln_len"][:, None] - rs.l_dis[0]
    # fronts: hop 1 = all out-link ring tails of my lane (strict-min), hop
    # 2 = my next link's end-lane tail, only within the scan bound
    has_next = rs.l_nxt[0] >= 0
    fresh1 = has_next & fx["best_ex"]
    g1 = lane_left0 + fx["best_val"]
    fresh2 = has_next & ~fx["best_ex"] & fx["ete"] \
        & (lane_left0 + fx["nlen"] <= bound)
    g2 = lane_left0 + fx["nlen"] + fx["etd"] - p_len
    gap0 = torch.where(fresh1, g1, torch.where(fresh2, g2, rs.l_gap[0]))
    new_l_gap = torch.cat([gap0[None], fresh_mid[1:]])
    # links: slots > 0 fresh; the front fresh iff the end-lane tail exists
    klead = shift_in(torch.full((1, LKp, B), 1e9, device=dev), rs.k_dis)
    kfresh = klead - p_len - rs.k_dis
    kgap0 = torch.where(fx["k_ete"], (net["lk_len"][:, None] - rs.k_dis[0])
                        + fx["k_etd"] - p_len, rs.k_gap[0])
    new_k_gap = torch.cat([kgap0[None], kfresh[1:]])
    return rs.replace_fields(l_gap=new_l_gap, k_gap=new_k_gap)


def lc_phase(net, cfg, rs, fx):
    """planLaneChange + scheduleLaneChange (engine.cpp:571-575, 792-820):
    signals (L1), arbitration and yield speeds (L2), shadow inserts (L3).
    Returns (rs with the shadows inserted, overflow bits per env: 1 = more
    than LCI changers into a lane, 2 = a full ring refused a shadow). The
    yield speed rides in rs.l_yv (100 = no-op), moved with the inserts."""
    p = cfg.params
    now = rs.step.to(torch.float32) * net["ring_f32"][len(p)]
    plan, hsig, gval, dirc, tl_slot, ygap = lc_signal(
        rs.l_dis, rs.l_speed, rs.n_l, rs.l_sh, rs.l_chg, rs.l_dir, rs.l_gap,
        rs.l_last, rs.l_rnrow, fx["olt_dis"], fx["olt_ex"], now, net,
        (p[P_LEN], p[P_MAXNEGACC], p[P_MAXSPEED], cfg.interval))
    yv, do_change = lc_receive(plan, dirc, tl_slot, ygap, hsig, gval,
                               rs.l_speed, rs.l_pri, rs.n_l, rs.l_chg, net,
                               (p[P_MAXNEGACC], cfg.interval))
    ch = {k: getattr(rs, v) for k, v in _INSERT_LEAVES.items()}
    out, n_l, ovl = lc_insert(ch, do_change, dirc, yv, rs.n_l, net, cfg.LCI)
    M = cfg.MAXLPR
    ov = (ovl & 1).amax(0).to(torch.int32) | ((ovl & 2).amax(0)
                                                .to(torch.int32))
    rs = rs.replace_fields(
        n_l=n_l, l_yv=out["yv"],
        l_rnrow=torch.stack([out[f"rn{c}"] for c in range(M)]),
        l_auxrow=torch.stack([out[f"ax{c}"] for c in range(M)]),
        **{v: out[k] for k, v in _INSERT_LEAVES.items()
           if k not in ("rnrow", "auxrow")})
    return rs, ov


def partner_fetch(net, rs, chans):
    """For every paired row (a changing real, or a shadow), its partner's
    values of `chans` ((SL, LNp, B) float32 each) by uid match in the
    partner lane column. Returns ([fetched ...], found mask)."""
    return lc_partner(rs.l_uid, rs.l_sh, rs.l_dir, rs.n_l, rs.l_chg,
                      [c.to(torch.float32).contiguous() for c in chans], net)
