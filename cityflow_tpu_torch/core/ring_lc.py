"""Lane change in the gen-2 ring layout, PyTorch port of the JAX package's
core/ring_lc.py, with uniform or non-uniform vehicle templates (the rows'
parameters from their template index: T1 in refresh_gaps, L1's and L2's
template modes in lc_phase, and L3 copies a real's template to its
shadow).

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

  refresh_gaps   R6 gap_refresh
  lc_phase       L1 lc_signal -> L2 lc_receive -> L3 lc_insert
  partner_fetch  L4 lc_partner (the match mode; partner_gather: the gather
                 mode, at a match kept from it)
"""

import torch

from cityflow_tpu_torch.compiler.net import P_LEN, P_MAXNEGACC, P_MAXSPEED
from cityflow_tpu_torch.kernels.gap_refresh import gap_refresh
from cityflow_tpu_torch.kernels.lc_insert import lc_insert
from cityflow_tpu_torch.kernels.lc_partner import (lc_partner,
                                                   lc_partner_gather)
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
    (engine.cpp:581) through R6: a fresh gap where a leader exists within
    the scan bound, the previous (stale) value otherwise. fx =
    ring.lc_front_ctx. Non-uniform templates: the leader's length, my
    maxSpeed and usualNegAcc for the bound (JAX ring_lc.py:119-131)."""
    l_gap, k_gap = gap_refresh(cfg, net, rs, fx)
    return rs.replace_fields(l_gap=l_gap, k_gap=k_gap)


def lc_phase(net, cfg, rs, fx):
    """planLaneChange + scheduleLaneChange (engine.cpp:571-575, 792-820):
    signals (L1), arbitration and yield speeds (L2), shadow inserts (L3).
    Returns (rs with the shadows inserted, overflow bits per env: 1 = more
    than LCI changers into a lane, 2 = a full ring refused a shadow). The
    yield speed rides in rs.l_yv (100 = no-op), moved with the inserts.
    Like R3, this writes rs's lane leaves (and n_l) in place: a caller
    that keeps the state it passes in passes a copy."""
    p = cfg.params
    now = rs.step.to(torch.float32) * net["ring_f32"][len(p)]
    tm = {} if cfg.uniform else dict(tpl=rs.l_tpl, table=net["tpl_params"])
    plan, hsig, gval, dirc, tl_slot, ygap = lc_signal(
        rs.l_dis, rs.l_speed, rs.n_l, rs.l_sh, rs.l_chg, rs.l_dir, rs.l_gap,
        rs.l_last, rs.l_rnrow, fx["olt_dis"], fx["olt_ex"], now, net,
        (p[P_LEN], p[P_MAXNEGACC], p[P_MAXSPEED], cfg.interval),
        **({} if cfg.uniform else dict(tm, olt_len=fx["olt_len"])))
    yv, do_change = lc_receive(plan, dirc, tl_slot, ygap, hsig, gval,
                               rs.l_speed, rs.l_pri, rs.n_l, rs.l_chg, net,
                               (p[P_MAXNEGACC], cfg.interval), **tm)
    ch = {k: getattr(rs, v) for k, v in _INSERT_LEAVES.items()}
    if not cfg.uniform:
        ch["tpl"] = rs.l_tpl                 # a shadow copies its template
    # L3 writes the lane leaves, yv and n_l in place (as R3 does): the
    # state's leaves hold the inserts, and yv becomes l_yv
    _, _, ovl = lc_insert(ch, do_change, dirc, yv, rs.n_l, net, cfg.LCI)
    ov = (ovl & 1).amax(0).to(torch.int32) | ((ovl & 2).amax(0)
                                                .to(torch.int32))
    rs = rs.replace_fields(l_yv=yv)
    return rs, ov


def partner_fetch(net, rs, chans, with_match=False):
    """For every paired row (a changing real, or a shadow), its partner's
    values of `chans` ((SL, LNp, B) float32 each) by uid match in the
    partner lane column. Returns ([fetched ...], found mask), and with
    `with_match` also the match (where each row's partner lies, for
    partner_gather on the same l_uid, l_sh, l_dir and n_l)."""
    vals, found, match = lc_partner(
        rs.l_uid, rs.l_sh, rs.l_dir, rs.n_l, rs.l_chg, _f32(chans), net)
    return (vals, found, match) if with_match else (vals, found)


def partner_gather(net, match, chans):
    """partner_fetch's values of other channels at a match it returned,
    with no search: the leaves it matched on must not have changed."""
    return lc_partner_gather(match, _f32(chans), net)


def _f32(chans):
    return [c.to(torch.float32).contiguous() for c in chans]
