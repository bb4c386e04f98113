"""R2 ring_exits: front departures, removals, blockers and lights of the
ring step's commit (csrc/ring_exits.cu).

Three stages, each one launch (lane change runs all three, around L4's
two partner rounds; without it only the first):

ring_exits (the exits, JAX ring.py:1462-1483, 1530-1566, 1908-1929):
  lanes   an invalid vehicle's new distance clamped to its lane's length,
          IN PLACE in mid["new_dis_l"] (only this stage reads it; it comes
          back as dis_l);
          the front prefix of slots < XK that crosses the lane end
          (leave), its length x_l, which of them are removed (route end;
          under lane change also shadows) and which exit into a link, the
          count and travel-time sum of the removed per env (n_rm, t_rm),
          OV_HOPS for a crossing at a slot >= XK; under lane change
          leave spans all SL slots and the round-1 partner channels
          chanA / chanB (leavers into a link / at their route end) come
          out as float32
  links   the same prefix on the link rings (leave_k, x_k, OV_HOPS)
  blk     the committed blocker of each link: the front-most occupied
          failing slot's foe, else the front-most failing approach row's
  lights  TrafficLight::passTime, k_phase passes per intersection
          (without RL control)
ring_exits_pairs (JAX :1484-1515): a shadow's abort (it or its real
  crosses into a link), the changing real's lateral offset and whether it
  finishes, from the round-1 partner values
ring_exits_finish (JAX :1515-1529, 1545-1550): the finishes that a
  partner's abort cancels, the mid-ring deletions (die_mid), promotions and
  unlinks, and the aborted shadows added to n_rm / t_rm

t_rm is a float sum: the kernel sums each lane's slots, then the lanes in
a fixed order of its own (the plain version and JAX in torch.sum's /
XLA's order); counts are exact.

The exits kernel reads each lane's and link's slots only up to its count,
and the other fields only where its result depends on them (past the
lane's end, up to the front-most failing blocker); lanes, links and
lights take blocks of their own, and the per-env sums come from one
partial per block of 32 envs (exit_groups) in a second launch.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.state import OV_HOPS
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_pairs = 0     # of those, the lane-change stage ring_exits_pairs
launches_finish = 0    # and ring_exits_finish
F32 = torch.float32
I32 = torch.int32
MODES = {"exits": 0, "pairs": 1, "finish": 2}
# the exits kernel takes 32-bit offsets where every ring, table and
# partial holds fewer elements than this (the kernel caps it at 2^31 - 1),
# else 64-bit ones; 0 makes it take 64-bit ones everywhere
OFFSET_LIMIT = 2 ** 31 - 1


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        # state and mid
        "n_l", "l_nxt", "l_last", "l_sh", "l_chg", "l_dir",
        "l_off", "l_enter", "step", "nd_k", "n_k", "k_fail", "k_fffoe",
        "ap_fail", "ap_red", "ap_ffo", "phase", "remain", "new_spd_l",
        # tables
        "ln_len", "lk_len", "ln_maxoff_out", "ln_maxoff_in", "i_n_phases",
        "i_virtual", "i_phase_offset", "phase_time",
        # pair-stage inputs
        "leave_in", "pA", "pf", "abort_in", "finish_in", "pAb", "pFin",
        "pB", "n_rm_in", "t_rm_in",
        # outputs
        "dis_l", "leave", "x_l", "exited", "chanA", "chanB", "leave_k",
        "x_k", "blk", "phase_out", "remain_out", "abort_sh", "finish_pre",
        "new_off", "die_mid", "promote", "unlink_real", "unlink_sh",
        "n_rm", "t_rm", "ov", "npart", "tpart", "dpart")] \
        + [(n, ctypes.c_longlong) for n in (
            "SL", "LNp", "SK", "LKp", "B", "I", "AP", "XKl", "XKe", "PT",
            "k_phase", "lc", "lights", "off_lim")] \
        + [("dt", ctypes.c_float)]


def _occ(n, S):
    return torch.arange(S, device=n.device)[:, None, None] < n[None]


def ring_exits_plain(cfg, net, rs, mid):
    """Plain PyTorch version of the first stage (the commit's exit,
    removal, blocker and light regions as they stood inline)."""
    SL, SK, LNp, LKp = cfg.SL, cfg.SK, cfg.LNp, cfg.LKp
    G, LPI, AP = cfg.G, cfg.LPI, cfg.AP
    B = rs.n_l.shape[-1]
    dev = rs.n_l.device
    dt = net["ring_f32"][len(cfg.params)]
    sl_idx = torch.arange(SL, device=dev)[:, None, None]
    sk_idx = torch.arange(SK, device=dev)[:, None, None]
    occ_l = _occ(rs.n_l, SL)
    occ_k = _occ(rs.n_k, SK)
    lc = cfg.lane_change
    ov = torch.zeros((B,), dtype=I32, device=dev)
    new_dis_l = mid["new_dis_l"]
    invalid_l = occ_l & (rs.l_nxt < 0) & ~rs.l_last
    ln_len_b = net["ln_len"][:, None]
    # invalid vehicles never cross the lane end (v_inv stops them; the
    # clamp guards fp edges so they cannot fall off the ring); written in
    # place, as the kernel does
    new_dis_l.copy_(torch.where(
        invalid_l, torch.minimum(new_dis_l, ln_len_b), new_dis_l))
    cross_l = occ_l & (new_dis_l > ln_len_b)
    pref = torch.ones((LNp, B), dtype=torch.bool, device=dev)
    leave_pref_l = []
    for s in range(min(cfg.XK, SL)):
        pref = cross_l[s] & pref
        leave_pref_l.append(pref)
    x_l = sum(c.to(I32) for c in leave_pref_l)
    if SL > cfg.XK:
        deep = cross_l[cfg.XK:] & (sl_idx[cfg.XK:] < rs.n_l[None])
        ov = ov | deep.reshape(-1, B).any(0).to(I32) * OV_HOPS
    XKl = len(leave_pref_l)
    out = dict(dis_l=new_dis_l, x_l=x_l)
    if lc:
        leave_full = torch.cat([torch.stack(leave_pref_l), torch.zeros(
            (SL - XKl, LNp, B), dtype=torch.bool, device=dev)])
        # round 1 of the pair exchange: who transfers into a link / dies at
        # its route end this step
        out.update(leave=leave_full,
                   chanA=(leave_full & ~rs.l_last).to(F32),
                   chanB=(leave_full & rs.l_last).to(F32))
        # shadows never transfer (they abort at the lane end); an aborted
        # shadow counts as finished (the engine.cpp:296-303 hasFinished
        # guard passes for aborts)
        removed_l = [leave_pref_l[s] & (rs.l_last[s] | rs.l_sh[s])
                     for s in range(XKl)]
        exited_l = [leave_pref_l[s] & ~rs.l_last[s] & ~rs.l_sh[s]
                    & (rs.l_nxt[s] >= 0) for s in range(XKl)]
    else:
        out["leave"] = torch.stack(leave_pref_l)
        removed_l = [leave_pref_l[s] & rs.l_last[s] for s in range(XKl)]
        exited_l = [leave_pref_l[s] & ~rs.l_last[s] & (rs.l_nxt[s] >= 0)
                    for s in range(XKl)]
    out["exited"] = torch.stack(exited_l)
    now = rs.step.to(F32) * dt
    tt = now - rs.l_enter
    out["n_rm"] = sum(r.to(I32).sum(0, dtype=I32) for r in removed_l)
    out["t_rm"] = sum(torch.where(removed_l[s], tt[s], 0.0).sum(0)
                      for s in range(XKl))

    nd_k = mid["nd_k3"].reshape(SK, LKp, B)
    cross_k = occ_k & (nd_k > net["lk_len"][:, None])
    prefk = torch.ones((LKp, B), dtype=torch.bool, device=dev)
    leave_pref_k = []
    for s in range(min(cfg.XK, SK)):
        prefk = cross_k[s] & prefk
        leave_pref_k.append(prefk)
    out["x_k"] = sum(c.to(I32) for c in leave_pref_k)
    out["leave_k"] = torch.stack(leave_pref_k)
    if SK > cfg.XK:
        deepk = cross_k[cfg.XK:] & (sk_idx[cfg.XK:] < rs.n_k[None])
        ov = ov | deepk.reshape(-1, B).any(0).to(I32) * OV_HOPS

    # ---- blocker graph commit (front-most failing vehicle per link) -----
    occ_k3 = occ_k.reshape(SK, LPI, G, B)
    k_fail_all, k_fffoe_all = mid["k_fail"], mid["k_fffoe"]
    blk_new = torch.full((LPI, G, B), -1, dtype=I32, device=dev)
    for s in reversed(range(SK)):
        blk_new = torch.where(occ_k3[s] & k_fail_all[s], k_fffoe_all[s],
                              blk_new)
    for a in reversed(range(AP)):
        m = mid["ap_fail"][a] & ~mid["ap_red"][a]
        blk_new = torch.where((blk_new < 0) & m, mid["ap_ffo"][a], blk_new)
    out["blk"] = blk_new.reshape(LKp, B)

    # ---- lights (TrafficLight::passTime) --------------------------------
    phase, remain = rs.phase, rs.phase_remain
    if not cfg.rl_traffic_light:
        n_ph = net["i_n_phases"][:, None]
        has = (n_ph > 0) & ~net["i_virtual"][:, None]
        remain = torch.where(has, remain - dt, remain)
        pt = net["phase_time"]
        off = net["i_phase_offset"][:, None]
        for _ in range(cfg.k_phase):
            go = has & (remain <= 0)
            nxtp = torch.where(go, (phase + 1) % torch.clamp_min(n_ph, 1),
                               phase)
            tph = pt[(off + nxtp).clamp(0, pt.shape[0] - 1).long()]
            remain = torch.where(go, remain + tph, remain)
            phase = nxtp
    out.update(phase=phase, remain=remain, ov=ov)
    return out


def ring_exits_pairs_plain(cfg, net, rs, new_spd_l, leave, pA, pf):
    """Plain PyTorch version of the second stage (JAX ring.py:1497-1512):
    abort_sh and finish_pre as float32 (the round-2 partner channels) and
    the lateral offset new_off."""
    dt = net["ring_f32"][len(cfg.params)]
    occ_l = _occ(rs.n_l, cfg.SL)
    sh = rs.l_sh
    chg_real = occ_l & rs.l_chg & ~sh
    chanA = leave & ~rs.l_last
    pA = pA > 0.5
    # a shadow aborts when it or its real crosses into a link (abort wins
    # over a same-step finish)
    abort_sh = occ_l & sh & ~rs.l_last & (chanA | (pf & pA))
    dirn = rs.l_dir.to(F32)
    max_off = torch.where(rs.l_dir > 0, net["ln_maxoff_out"][:, None],
                          net["ln_maxoff_in"][:, None])
    new_off = torch.minimum(torch.abs(
        rs.l_off + torch.clamp_min(0.2 * new_spd_l, 1.0) * dt * dirn),
        max_off)
    finish_pre = chg_real & (new_off >= max_off) & ~leave
    return dict(abort_sh=abort_sh.to(F32), finish_pre=finish_pre.to(F32),
                new_off=new_off)


def ring_exits_finish_plain(cfg, net, rs, leave, abort_sh, finish_pre, pAb,
                            pFin, pf, pB, n_rm, t_rm):
    """Plain PyTorch version of the third stage (JAX ring.py:1515-1529,
    1545-1550)."""
    dt = net["ring_f32"][len(cfg.params)]
    occ_l = _occ(rs.n_l, cfg.SL)
    sh = rs.l_sh
    chg_real = occ_l & rs.l_chg & ~sh
    abort_sh, finish_pre = abort_sh > 0.5, finish_pre > 0.5
    pAb, pFin, pB = pAb > 0.5, pFin > 0.5, pB > 0.5
    finish = finish_pre & ~(pf & pAb)
    cm = abort_sh & ~leave
    tt = rs.step.to(F32) * dt - rs.l_enter
    return dict(
        die_mid=finish | cm,
        promote=occ_l & sh & ~abort_sh & pf & pFin,
        unlink_real=chg_real & (~pf | pAb | pB),
        unlink_sh=occ_l & sh & (~pf | pB),
        n_rm=n_rm + cm.to(I32).sum((0, 1), dtype=I32),
        t_rm=t_rm + torch.where(cm, tt, 0.0).sum((0, 1)))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_T = ("n_l", "l_nxt", "l_last", "l_sh", "l_chg", "l_dir", "l_off",
      "l_enter", "step", "nd_k", "n_k", "k_fail", "k_fffoe", "ap_fail",
      "ap_red", "ap_ffo", "phase", "remain", "new_spd_l")
_NET = ("ln_len", "lk_len", "ln_maxoff_out", "ln_maxoff_in", "i_n_phases",
        "i_virtual", "i_phase_offset", "phase_time")


def _check_state(name, cfg, rs, tensors, dtypes, cpu):
    SL, LNp = cfg.SL, cfg.LNp
    B = rs.n_l.shape[-1]
    _lib.check_args(name, rs.n_l, rs.l_last, rs.l_sh, *tensors,
                    dtypes=[(I32,), (torch.bool,), (torch.bool,)] + dtypes,
                    cuda=not cpu)
    for t in (rs.l_last, rs.l_sh) + tuple(tensors):
        if t is not None and t.dim() == 3 and tuple(t.shape) != (SL, LNp, B):
            raise ValueError(f"{name}: lane ring {tuple(t.shape)}")
    if tuple(rs.n_l.shape) != (LNp, B):
        raise ValueError(f"{name}: n_l {tuple(rs.n_l.shape)}")


def ring_exits(cfg, net, rs, mid):
    """R2's first stage on CUDA tensors, the plain version on CPU tensors.
    Returns dict(dis_l, leave, x_l, exited, n_rm, t_rm, leave_k, x_k, blk,
    phase, remain, ov [, chanA, chanB]). Writes the clamp of the invalid
    vehicles into mid["new_dis_l"] (contiguous, or refused), which comes
    back as dis_l."""
    SK, LKp, AP = cfg.SK, cfg.LKp, cfg.AP
    B = rs.n_l.shape[-1]
    cpu = rs.n_l.device.type == "cpu"
    b8 = (torch.bool,)
    ms = [mid[k] for k in ("new_dis_l", "nd_k3", "k_fail", "k_fffoe",
                           "ap_fail", "ap_red", "ap_ffo")]
    _check_state("ring_exits", cfg, rs,
                 [rs.l_nxt, rs.l_enter, rs.step, rs.n_k, rs.phase,
                  rs.phase_remain] + ms,
                 [(I32,), (F32,), (I32,), (I32,), (I32,), (F32,), (F32,),
                  (F32,), b8, (I32,), b8, b8, (I32,)], cpu)
    for k, rows in (("nd_k3", SK), ("k_fail", SK), ("k_fffoe", SK),
                    ("ap_fail", AP), ("ap_red", AP), ("ap_ffo", AP)):
        if mid[k].numel() != rows * LKp * B:
            raise ValueError(f"ring_exits: mid {k} {tuple(mid[k].shape)}")
    if cpu:
        return ring_exits_plain(cfg, net, rs, mid)
    return _launch_exits(cfg, net, rs, mid)


def ring_exits_pairs(cfg, net, rs, new_spd_l, leave, pA, pf):
    """R2's second stage (lane change) on CUDA tensors, the plain version
    on CPU tensors. Returns dict(abort_sh, finish_pre, new_off)."""
    cpu = rs.n_l.device.type == "cpu"
    _check_state("ring_exits_pairs", cfg, rs,
                 [rs.l_chg, rs.l_dir, rs.l_off, new_spd_l, leave, pA, pf],
                 [(torch.bool,), (I32,), (F32,), (F32,), (torch.bool,),
                  (F32,), (torch.bool,)], cpu)
    if cpu:
        return ring_exits_pairs_plain(cfg, net, rs, new_spd_l, leave, pA,
                                      pf)
    return _launch_pairs(cfg, net, rs, new_spd_l, leave, pA, pf)


def ring_exits_finish(cfg, net, rs, leave, abort_sh, finish_pre, pAb, pFin,
                      pf, pB, n_rm, t_rm):
    """R2's third stage (lane change) on CUDA tensors, the plain version on
    CPU tensors. Returns dict(die_mid, promote, unlink_real, unlink_sh,
    n_rm, t_rm)."""
    cpu = rs.n_l.device.type == "cpu"
    b8 = (torch.bool,)
    _check_state("ring_exits_finish", cfg, rs,
                 [rs.l_chg, rs.l_enter, rs.step, leave, abort_sh, finish_pre,
                  pAb, pFin, pf, pB, n_rm, t_rm],
                 [b8, (F32,), (I32,), b8, (F32,), (F32,), (F32,), (F32,), b8,
                  (F32,), (I32,), (F32,)], cpu)
    if cpu:
        return ring_exits_finish_plain(cfg, net, rs, leave, abort_sh,
                                       finish_pre, pAb, pFin, pf, pB, n_rm,
                                       t_rm)
    return _launch_finish(cfg, net, rs, leave, abort_sh, finish_pre, pAb,
                          pFin, pf, pB, n_rm, t_rm)


def _call(cfg, net, mode, B, like, T=None, inp=None, outs=None):
    """Fill the argument block (None for what the mode does not use) and
    launch on `like`'s stream."""
    global launches, launches_pairs, launches_finish
    ptr = lambda t: None if t is None else t.data_ptr()
    T, inp, outs = T or {}, inp or {}, outs or {}
    names = [f for f, _ in _Args._fields_]
    vals = {k: ptr(T.get(k)) for k in _T}
    vals.update({k: net[k].data_ptr() for k in _NET})
    vals.update({k: ptr(v) for k, v in inp.items()})
    vals.update({k: ptr(v) for k, v in outs.items()})
    XK = cfg.XK
    vals.update(SL=cfg.SL, LNp=cfg.LNp, SK=cfg.SK, LKp=cfg.LKp, B=B,
                I=cfg.I, AP=cfg.AP, XKl=min(XK, cfg.SL), XKe=min(XK, cfg.SK),
                PT=net["phase_time"].shape[0], k_phase=cfg.k_phase,
                lc=int(cfg.lane_change),
                lights=int(not cfg.rl_traffic_light), off_lim=OFFSET_LIMIT,
                dt=cfg.interval)
    a = _Args(**{k: vals.get(k) for k in names})
    _lib.check(_lib.lib().ring_exits(ctypes.byref(a), MODES[mode],
                                     _lib.stream_ptr(like)), "ring_exits")
    launches += 1
    launches_pairs += int(mode == "pairs")
    launches_finish += int(mode == "finish")


def exit_groups(B, LNp, LKp):
    """(lane groups, link groups) of the exits kernel at B envs: the rows
    of the per-(group, env) partials it writes (csrc/ring_exits.cu
    ex_geom)."""
    nlg, nkg = ctypes.c_longlong(), ctypes.c_longlong()
    _lib.check(_lib.lib().ring_exits_groups(B, LNp, LKp, ctypes.byref(nlg),
                                            ctypes.byref(nkg)),
               "ring_exits_groups")
    return nlg.value, nkg.value


def _launch_exits(cfg, net, rs, mid):
    SL, SK, LNp, LKp = cfg.SL, cfg.SK, cfg.LNp, cfg.LKp
    B = rs.n_l.shape[-1]
    dev = rs.n_l.device
    lc = cfg.lane_change
    XKl, XKe = min(cfg.XK, SL), min(cfg.XK, SK)
    e = lambda *s, dt=F32: torch.empty(s, dtype=dt, device=dev)
    b8 = torch.bool
    out = dict(dis_l=mid["new_dis_l"],
               leave=e(SL if lc else XKl, LNp, B, dt=b8),
               x_l=e(LNp, B, dt=I32), exited=e(XKl, LNp, B, dt=b8),
               n_rm=e(B, dt=I32), t_rm=e(B), leave_k=e(XKe, LKp, B, dt=b8),
               x_k=e(LKp, B, dt=I32), blk=e(LKp, B, dt=I32),
               ov=e(B, dt=I32))
    if lc:
        out.update(chanA=e(SL, LNp, B), chanB=e(SL, LNp, B))
    lights = not cfg.rl_traffic_light
    if lights:
        out.update(phase=e(cfg.I, B, dt=I32), remain=e(cfg.I, B))
    T = dict(n_l=rs.n_l, l_nxt=rs.l_nxt,
             l_last=rs.l_last, l_sh=rs.l_sh, l_enter=rs.l_enter,
             step=rs.step, nd_k=mid["nd_k3"], n_k=rs.n_k,
             k_fail=mid["k_fail"], k_fffoe=mid["k_fffoe"],
             ap_fail=mid["ap_fail"], ap_red=mid["ap_red"],
             ap_ffo=mid["ap_ffo"], phase=rs.phase, remain=rs.phase_remain)
    nlg, nkg = exit_groups(B, LNp, LKp)
    scratch = dict(npart=e(nlg, B, dt=I32), tpart=e(nlg, B),
                   dpart=e(nlg + nkg, B, dt=I32))
    outs = {k: v for k, v in out.items() if k not in ("phase", "remain")}
    _call(cfg, net, "exits", B, rs.n_l, T=T,
          outs=dict(outs, phase_out=out.get("phase"),
                    remain_out=out.get("remain"), **scratch))
    if not lights:
        out.update(phase=rs.phase, remain=rs.phase_remain)
    return out


def _launch_pairs(cfg, net, rs, new_spd_l, leave, pA, pf):
    SL, LNp = cfg.SL, cfg.LNp
    B = rs.n_l.shape[-1]
    dev = rs.n_l.device
    out = {k: torch.empty((SL, LNp, B), dtype=F32, device=dev)
           for k in ("abort_sh", "finish_pre", "new_off")}
    T = dict(n_l=rs.n_l, l_last=rs.l_last, l_sh=rs.l_sh, l_chg=rs.l_chg,
             l_dir=rs.l_dir, l_off=rs.l_off, new_spd_l=new_spd_l)
    _call(cfg, net, "pairs", B, rs.n_l, T=T,
          inp=dict(leave_in=leave, pA=pA, pf=pf), outs=out)
    return out


def _launch_finish(cfg, net, rs, leave, abort_sh, finish_pre, pAb, pFin, pf,
                   pB, n_rm, t_rm):
    SL, LNp = cfg.SL, cfg.LNp
    B = rs.n_l.shape[-1]
    dev = rs.n_l.device
    out = {k: torch.empty((SL, LNp, B), dtype=torch.bool, device=dev)
           for k in ("die_mid", "promote", "unlink_real", "unlink_sh")}
    out.update(n_rm=torch.empty((B,), dtype=I32, device=dev),
               t_rm=torch.empty((B,), dtype=F32, device=dev))
    T = dict(n_l=rs.n_l, l_sh=rs.l_sh, l_chg=rs.l_chg, l_enter=rs.l_enter,
             step=rs.step)
    _call(cfg, net, "finish", B, rs.n_l, T=T,
          inp=dict(leave_in=leave, abort_in=abort_sh, finish_in=finish_pre,
                   pAb=pAb, pFin=pFin, pf=pf, pB=pB,
                   n_rm_in=n_rm, t_rm_in=t_rm),
          outs=dict(out, npart=torch.empty((LNp, B), dtype=I32, device=dev),
                    tpart=torch.empty((LNp, B), dtype=F32, device=dev)))
    return out
