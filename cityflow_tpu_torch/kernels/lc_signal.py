"""L1 lc_signal: SimpleLaneChange::makeSignal, the target lane's leader and
follower, and the gap validity of every lane slot (csrc/lc_signal.cu).

Per (slot, lane, env) of the (SL, LNp, B) lane rings: rank counts against
the inner and outer neighbour rings (the leader of distance d is slot
cnt - 1 with cnt = #{occupied slots with dis >= d}, the follower slot cnt),
the signal and its direction, the leader gap with the target lane's
out-link ring tails as fallback, and the follower's yield gap. Uniform
vehicle templates (the scalar parameters of the config).

Outputs: plan, has_signal, gap_valid (bool), dirc, tl_slot (int32, the
target leader's slot, -1 without one), ygap (float32, the sender-side
yield gap).
"""

import ctypes

import torch

from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels._nbr import nbcol

launches = 0
COOLING_TIME = 3.0      # lanechange.h:43; lastChangeTime is never written
                        # after construction, so the cooldown reduces to
                        # now >= COOLING_TIME


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "dis", "speed", "n_l", "sh", "chg", "dir", "gap", "last", "rnrow",
        "olt_dis", "olt_ex", "now", "inner", "outer", "ln_len", "llocal",
        "plan", "hsig", "gval", "dirc", "tl_slot", "ygap")] \
        + [(n, ctypes.c_longlong) for n in ("S", "N", "B")] \
        + [("M", ctypes.c_int), ("KOUT", ctypes.c_int)] \
        + [(n, ctypes.c_float) for n in ("len", "neg", "expected", "len15",
                                         "cooling")]


def _consts(prm):
    """(len, maxNegAcc, maxSpeed, interval) -> the signal's thresholds,
    computed in double and used as float32 (JAX's weak Python floats)."""
    p_len, p_neg, p_spd, interval = prm
    return dict(len=p_len, neg=p_neg,
                expected=2 * p_len + 4 * interval * p_spd,
                len15=1.5 * p_len, cooling=COOLING_TIME)


def _probe(dis, speed, n_l, src):
    """Leader / follower of every slot in the neighbour column `src`."""
    SL = dis.shape[0]
    nb_dis, nb_spd, nb_n = nbcol(dis, src), nbcol(speed, src), nbcol(n_l, src)
    cnt = torch.zeros(dis.shape, dtype=torch.int32, device=dis.device)
    for t in range(SL):
        cnt += ((t < nb_n) & (nb_dis[t] >= dis)).to(torch.int32)
    lead_ex = cnt > 0
    foll_ex = cnt < nb_n[None]
    li = (cnt - 1).clamp(min=0).long()
    fi = cnt.clamp(max=SL - 1).long()
    return dict(
        cnt=cnt, lead_ex=lead_ex, foll_ex=foll_ex,
        lead_dis=torch.where(lead_ex, torch.gather(nb_dis, 0, li), 0.0),
        foll_dis=torch.where(foll_ex, torch.gather(nb_dis, 0, fi), 0.0),
        foll_spd=torch.where(foll_ex, torch.gather(nb_spd, 0, fi), 0.0))


def sel_llocal(bundle, llocal, delta):
    """The (llocal + delta) row of a (M, SL, LNp, B) route-row bundle per
    lane column, -1 where that lane index does not exist."""
    out = torch.full_like(bundle[0], -1)
    for c in range(bundle.shape[0]):
        out = torch.where((llocal + delta == c)[:, None], bundle[c], out)
    return out


def lc_signal_plain(dis, speed, n_l, sh, chg, l_dir, l_gap, l_last, rnrow,
                    olt_dis, olt_ex, now, tabs, prm):
    """Plain PyTorch version: ring_lc.lc_phase of the JAX package from the
    neighbour rings to the gap validity (ring_lc.py:192-311)."""
    c = _consts(prm)
    p_len, p_neg = c["len"], c["neg"]
    SL = dis.shape[0]
    dev = dis.device
    inner, outer = tabs["inner_src"], tabs["outer_src"]
    occ = torch.arange(SL, device=dev)[:, None, None] < n_l[None]
    lane_left = tabs["ln_len"][:, None] - dis
    no = _probe(dis, speed, n_l, outer)
    ni = _probe(dis, speed, n_l, inner)

    # SimpleLaneChange::makeSignal (lanechange.cpp:151-184)
    mk = occ & ~sh & ~chg & (now >= c["cooling"])
    has_signal = mk | (occ & ~sh & chg)
    cur_est = l_gap
    want = mk & (lane_left >= 30) & ~(cur_est > c["expected"]) \
        & ~(cur_est < c["len15"])
    llocal = tabs["ln_llocal"]
    reach_out = l_last | (sel_llocal(rnrow, llocal, 1) >= 0)
    reach_in = l_last | (sel_llocal(rnrow, llocal, -1) >= 0)
    ln_len = tabs["ln_len"][:, None]
    len_out, len_in = nbcol(ln_len, outer), nbcol(ln_len, inner)

    def estimate(e, nb_len):        # estimateGap (lanechange.cpp:215-220)
        return torch.where(e["lead_ex"], e["lead_dis"] - dis - p_len,
                           nb_len - dis)

    outer_ok = want & (outer >= 0)[:, None] & reach_out
    outer_est = torch.where(outer_ok, estimate(no, len_out), 0.0)
    dir_new = torch.where(outer_ok & (outer_est > cur_est + p_len), 1, 0) \
        .to(torch.int32)
    inner_ok = want & (inner >= 0)[:, None] & reach_in
    inner_est = estimate(ni, len_in)
    take_inner = inner_ok & (inner_est > cur_est + p_len) \
        & (inner_est > outer_est)
    dir_new = torch.where(take_inner, -1, dir_new).to(torch.int32)
    dirc = torch.where(chg, l_dir, dir_new)
    plan = occ & ~sh & ((has_signal & (dirc != 0)) | chg)

    # updateLeaderAndFollower (lanechange.cpp:27-60) on the target side
    up = dirc > 0
    dsel = lambda k: torch.where(up, no[k], ni[k])
    tl_ex, tf_ex = dsel("lead_ex"), dsel("foll_ex")
    lgap = torch.where(tl_ex, dsel("lead_dis") - dis - p_len, lane_left)
    # no on-lane leader: the target lane's out-link ring tails in laneLinks
    # order, running strict-min (lanechange.cpp:33-47)
    olt_o, olt_i = nbcol(olt_dis, outer), nbcol(olt_dis, inner)
    oex_o, oex_i = nbcol(olt_ex, outer), nbcol(olt_ex, inner)
    best = torch.full(dis.shape, torch.inf, device=dev)
    for k in range(olt_dis.shape[0]):
        cgap = torch.where(up, olt_o[k], olt_i[k]) + lane_left
        better = ~tl_ex & torch.where(up, oex_o[k], oex_i[k]) & (cgap < best)
        hit = better & (cgap < p_len)
        lgap = torch.where(hit, lane_left - (p_len - cgap), lgap)
        best = torch.where(better, cgap, best)
    fgap = torch.where(tf_ex, dis - dsel("foll_dis") - p_len, torch.inf)
    # gap validity (lanechange.h:80): my minBrake ahead, the follower's
    # behind
    min_brake = 0.5 * speed * speed / p_neg
    tf_spd = dsel("foll_spd")
    safe_before = torch.where(tf_ex, 0.5 * tf_spd * tf_spd / p_neg, 0.0)
    gap_valid = (lgap >= min_brake) & (fgap >= safe_before)
    return (plan, has_signal, gap_valid, dirc, dsel("cnt") - 1,
            fgap - safe_before)


def lc_signal(dis, speed, n_l, sh, chg, l_dir, l_gap, l_last, rnrow,
              olt_dis, olt_ex, now, tabs, prm):
    """L1 on CUDA tensors, the plain version on CPU tensors.

    Lane rings (SL, LNp, B); n_l (LNp, B); rnrow (M, SL, LNp, B);
    olt_dis / olt_ex (KOUT, LNp, B); now (B,) float32 seconds; tabs holds
    inner_src, outer_src, ln_len, ln_llocal; prm = (len, maxNegAcc,
    maxSpeed, interval)."""
    global launches
    SL, N, B = dis.shape
    M, KOUT = rnrow.shape[0], olt_dis.shape[0]
    f32, i32, b8 = (torch.float32,), (torch.int32,), (torch.bool,)
    ins = (dis, speed, n_l, sh, chg, l_dir, l_gap, l_last, rnrow, olt_dis,
           olt_ex, now, tabs["inner_src"], tabs["outer_src"], tabs["ln_len"],
           tabs["ln_llocal"])
    cpu = dis.device.type == "cpu"
    _lib.check_args("lc_signal", *ins,
                    dtypes=[f32, f32, i32, b8, b8, i32, f32, b8, i32, f32,
                            b8, f32, i32, i32, f32, i32], cuda=not cpu)
    for name, t, shp in (("n_l", n_l, (N, B)), ("rnrow", rnrow, (M, SL, N, B)),
                         ("olt_ex", olt_ex, (KOUT, N, B)), ("now", now, (B,))):
        if tuple(t.shape) != shp:
            raise ValueError(f"lc_signal: {name} {tuple(t.shape)} != {shp}")
    for t in (speed, sh, chg, l_dir, l_gap, l_last):
        if tuple(t.shape) != (SL, N, B):
            raise ValueError(f"lc_signal: ring {tuple(t.shape)}")
    if cpu:
        return lc_signal_plain(dis, speed, n_l, sh, chg, l_dir, l_gap, l_last,
                               rnrow, olt_dis, olt_ex, now, tabs, prm)
    e = lambda dt: torch.empty((SL, N, B), dtype=dt, device=dis.device)
    outs = (e(torch.bool), e(torch.bool), e(torch.bool), e(torch.int32),
            e(torch.int32), e(torch.float32))
    c = _consts(prm)
    a = _Args(*(t.data_ptr() for t in ins + outs), SL, N, B, M, KOUT,
              c["len"], c["neg"], c["expected"], c["len15"], c["cooling"])
    rc = _lib.lib().lc_signal(ctypes.byref(a), _lib.stream_ptr(dis))
    _lib.check(rc, "lc_signal")
    launches += 1
    return outs
