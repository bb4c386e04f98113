"""R3 ring_admit: spawn and admission on the ring layout, written in place
(csrc/ring_admit.cu).

Flow::nextStep + Engine::handleWaiting (engine.cpp:502-516): each entry
lane e of each env b reads its spawn-queue row at el_cursor; the row is
due when it exists and its step has come. Lane::available
(roadnet.cpp:428-436) holds when the entry lane is empty or its tail's
distance exceeds the tail's length plus the incoming vehicle's minGap
(template lengths with non-uniform templates). A due, available row is
admitted into slot n_l of lane el_lane[e] when that slot exists; a due,
available row on a full lane sets OV_SLOTS. The admitted vehicle starts
at distance 0 with its route's first hops (nxt, the two-hop nxt3, last),
its spawn step times the interval as enter time, and, under lane change,
its route-row bundles at rpos 0 and its admission-time gap
(updateLeaderAndGap with the pre-push tail, or the scan past the lane's
end: the out-link ring tails, then the first link's end-lane tail within
the lookahead bound).

`rs` is the trailing-batch RingState; its lane leaves, n_l and el_cursor
(ADMIT_FIELDS) are written in place: the caller passes a state it no
longer needs (the batched ring entries, as JAX donates theirs; the
single-env entries pass copies). `q` holds the (EL, QCAP) int32 spawn
queues shared by the envs; under lane change best_ex / best_val are
lc_front_ctx's (LNp, B) out-link winner of each lane. Returns the OV_SLOTS
bits per env, (B,) int32.
"""

import ctypes

import torch

from cityflow_tpu_torch.compiler.net import (
    P_LEN, P_MAXSPEED, P_MINGAP, P_SPEED, P_USUALNEGACC)
from cityflow_tpu_torch.core.numerics import jnp_take, xla_f32_to_i32
from cityflow_tpu_torch.core.state import OV_SLOTS
from cityflow_tpu_torch.core.step import leader_scan_bound
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels.gather_rows import gather_rows_plain
from cityflow_tpu_torch.kernels.tpl_params import tpl_params_plain

launches = 0
launches_lc = 0        # of those, with lane change
launches_tpl = 0       # of those, with non-uniform templates
F32 = torch.float32
I32 = torch.int32

# the leaves the admission writes (lane change / templates: when present)
ADMIT_FIELDS = ("n_l", "el_cursor", "l_dis", "l_speed", "l_flow", "l_route",
                "l_rpos", "l_nxt", "l_nxt3", "l_prev", "l_enter", "l_pri",
                "l_uid", "l_last", "l_custom", "l_hascustom", "l_off", "l_sh",
                "l_chg", "l_dir", "l_gap", "l_yv", "l_rnrow", "l_auxrow",
                "l_tpl")
_QKEYS = ("step", "flow", "pri", "route", "uid", "tpl")


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q_step", "q_flow", "q_pri", "q_route", "q_uid", "q_tpl", "step",
        "el_lane", "ln_llocal", "route_next", "route_aux", "route_len",
        "lk_end_lane", "ln_len", "lk_len", "table", "best_ex", "best_val",
        "n_l", "el_cursor", "l_dis", "l_speed", "l_flow", "l_route",
        "l_rpos", "l_nxt", "l_nxt3", "l_prev", "l_enter", "l_pri", "l_uid",
        "l_last", "l_custom", "l_hascustom", "l_off", "l_sh", "l_chg",
        "l_dir", "l_gap", "l_yv", "l_rnrow", "l_auxrow", "l_tpl", "adm",
        "ov")] \
        + [(n, ctypes.c_longlong) for n in (
            "EL", "QCAP", "SL", "LNp", "LKp", "B", "NR", "RLEN", "MAXLPR",
            "TP")] \
        + [(n, ctypes.c_float) for n in (
            "p_speed0", "p_len", "p_avail", "approach", "dt")]


def ring_admit_plain(cfg, net, rs, q, best_ex=None, best_val=None):
    """Plain PyTorch version (the ring step's admission region as it stood
    inline, JAX ring.py:489-643), writing rs's leaves in place."""
    SL, LNp, LKp = cfg.SL, cfg.LNp, cfg.LKp
    dev = rs.n_l.device
    B = rs.n_l.shape[-1]
    uni, lc = cfg.uniform, cfg.lane_change
    prm = cfg.params
    p_speed0, p_len, p_una = prm[P_SPEED], prm[P_LEN], prm[P_USUALNEGACC]
    p_mingap, p_maxspd = prm[P_MINGAP], prm[P_MAXSPEED]
    approach = leader_scan_bound(p_maxspd, p_una, cfg.interval)
    dt = net["ring_f32"][len(prm)]
    tpp = net["tpl_params"]

    el_lane = net["el_lane"]
    el_l = el_lane.long()
    QCAP = q["step"].shape[1]
    cur = rs.el_cursor.clamp(0, QCAP - 1).long()                 # (EL, B)
    row = {k: torch.gather(v, 1, cur) for k, v in q.items()}
    has_row = (rs.el_cursor < QCAP) & (row["step"] >= 0) \
        & (row["step"] <= rs.step[None])
    n_e = rs.n_l[el_l]                                           # (EL, B)
    tail_flat = (n_e - 1).clamp(min=0) * LNp + el_lane[:, None]
    t_dis = torch.gather(rs.l_dis.reshape(SL * LNp, B), 0, tail_flat.long())
    # Lane::available (roadnet.cpp:428-436): tail dis > tail len +
    # INCOMING vehicle's minGap
    if uni:
        avail_e = (n_e == 0) | (t_dis > p_len + p_mingap)
    else:
        t_tpl_e = torch.gather(rs.l_tpl.reshape(SL * LNp, B), 0,
                               tail_flat.long())
        t_len_e = tpl_params_plain(t_tpl_e, tpp, (P_LEN,))[0]
        qcols = (P_SPEED, P_MINGAP, P_MAXSPEED, P_USUALNEGACC)
        q_pp = dict(zip(qcols, tpl_params_plain(row["tpl"], tpp, qcols)))
        avail_e = (n_e == 0) | (t_dis > t_len_e + q_pp[P_MINGAP])
    admit = has_row & avail_e & (n_e < SL)
    ov = (has_row & avail_e & (n_e >= SL)).any(0).to(I32) * OV_SLOTS

    ln_llocal = net["ln_llocal"]
    rn = net["route_next"]
    NR, RLEN, MAXLPR = rn.shape
    rn_flat = rn.reshape(-1)

    def rn_at(route, pos, llocal):
        p = pos.clamp(0, RLEN - 1) if torch.is_tensor(pos) \
            else min(max(pos, 0), RLEN - 1)
        fi = (route.clamp(0, NR - 1) * RLEN + p) * MAXLPR \
            + llocal.clamp(0, MAXLPR - 1)
        return rn_flat[fi.long()]

    rt = row["route"].clamp(0, NR - 1)
    nxt0 = rn_at(rt, 0, ln_llocal[el_l][:, None])
    end0 = net["lk_end_lane"][(nxt0 - LNp).clamp(0, LKp - 1).long()]
    nxt3_0 = torch.where(
        nxt0 >= 0, rn_at(rt, 1, jnp_take(ln_llocal, end0.clamp(min=0))), -1)
    last0 = net["route_len"][rt.long()] <= 1

    # spread entry-lane values to the lane axis (el_src)
    pri_h0 = (row["pri"] >> 16).to(F32)
    pri_l0 = (row["pri"] & 0xFFFF).to(F32)
    sp_vals = [row["flow"], rt, nxt0, nxt3_0, pri_h0, pri_l0, row["uid"],
               last0, row["step"]]
    if lc:
        # route-row bundles of (route, rpos=0), and the admission-time gap:
        # handleWaiting runs updateLeaderAndGap with the pre-push tail
        # (engine.cpp:510-512); an empty lane scans the entry lane's
        # out-link ring tails, then the first link's end-lane tail within
        # the lookahead bound
        base = rt * (RLEN * MAXLPR)
        aux_flat = net["route_aux"].reshape(-1)
        sp_vals += [rn_flat[(base + c).long()] for c in range(MAXLPR)]
        sp_vals += [aux_flat[(base + c).long()] for c in range(MAXLPR)]
        ln_len_e = net["ln_len"][el_l][:, None]
        nlen_e = net["lk_len"][(nxt0 - LNp).clamp(0, LKp - 1).long()]
        end_c = end0.clamp(0, LNp - 1).long()
        n_end = torch.gather(rs.n_l, 0, end_c)
        end_tail = (n_end - 1).clamp(min=0).long() * LNp + end_c
        etd_e = torch.gather(rs.l_dis.reshape(SL * LNp, B), 0, end_tail)
        if uni:
            etl_e = tl_len_e = p_len     # end-lane tail's, entry tail's len
            approach_e = approach        # my lookahead bound
        else:
            etl_e = tpl_params_plain(torch.gather(
                rs.l_tpl.reshape(SL * LNp, B), 0, end_tail), tpp,
                (P_LEN,))[0]
            tl_len_e = t_len_e
            approach_e = leader_scan_bound(q_pp[P_MAXSPEED],
                                           q_pp[P_USUALNEGACC], cfg.interval)
        b_ex_e = best_ex[el_l]
        f1_e = (nxt0 >= 0) & b_ex_e
        f2_e = (nxt0 >= 0) & ~b_ex_e & (n_end > 0) \
            & (ln_len_e + nlen_e <= approach_e)
        scan_gap = torch.where(
            f1_e, ln_len_e + best_val[el_l],
            torch.where(f2_e, ln_len_e + nlen_e + etd_e - etl_e, 0.0))
        sp_vals.append(torch.where(n_e > 0, t_dis - tl_len_e, scan_gap))
    i_tpl = len(sp_vals) + 1             # template rows of sp (non-uniform)
    if not uni:
        # the spawn speed is the template's startSpeed; the template index
        # rides the ring like flow / route (VehicleInfo at Flow::nextStep)
        sp_vals += [q_pp[P_SPEED], row["tpl"]]
    sp_in = [admit.to(F32)] + [torch.where(admit, v.to(F32), 0.0)
                               for v in sp_vals]
    sp = gather_rows_plain(torch.stack(sp_in), net["el_src"], 0.0)
    adm_lane = sp[0] > 0.5
    sl_idx = torch.arange(SL, device=dev)[:, None, None]
    place = adm_lane[None] & (sl_idx == rs.n_l[None])

    def put(a, dense_v):
        v = dense_v if a.dtype == F32 else xla_f32_to_i32(dense_v)
        a.copy_(torch.where(place, v[None], a))

    def putc(a, const):
        a.copy_(torch.where(place, const, a))

    putc(rs.l_dis, 0.0)
    if uni:
        putc(rs.l_speed, p_speed0)
    else:
        put(rs.l_speed, sp[i_tpl])
    put(rs.l_flow, sp[1])
    put(rs.l_route, sp[2])
    putc(rs.l_rpos, 0)
    put(rs.l_nxt, sp[3])
    put(rs.l_nxt3, sp[4])
    putc(rs.l_prev, -1)
    # enterTime is the SPAWN step (Vehicle ctor at Flow::nextStep)
    put(rs.l_enter, sp[9] * dt)
    rs.l_pri.copy_(torch.where(
        place, ((xla_f32_to_i32(sp[5]) << 16) | xla_f32_to_i32(sp[6]))[None],
        rs.l_pri))
    put(rs.l_uid, sp[7])
    rs.l_last.copy_(torch.where(place, (sp[8] > 0.5)[None], rs.l_last))
    putc(rs.l_custom, 0.0)
    putc(rs.l_hascustom, False)
    if lc:
        putc(rs.l_off, 0.0)
        putc(rs.l_sh, False)
        putc(rs.l_chg, False)
        putc(rs.l_dir, 0)
        put(rs.l_gap, sp[10 + 2 * MAXLPR])
        putc(rs.l_yv, 100.0)
        for c in range(MAXLPR):
            put(rs.l_rnrow[c], sp[10 + c])
            put(rs.l_auxrow[c], sp[10 + MAXLPR + c])
    if not uni:
        put(rs.l_tpl, sp[i_tpl + 1])
    rs.n_l.add_(adm_lane.to(I32))
    rs.el_cursor.add_(admit.to(I32))
    return ov


def _leaves(cfg, rs):
    return [getattr(rs, k) for k in ADMIT_FIELDS
            if getattr(rs, k) is not None]


def ring_admit(cfg, net, rs, q, best_ex=None, best_val=None):
    """R3 on CUDA tensors, the plain version on CPU tensors; writes rs's
    admission leaves in place and returns the OV_SLOTS bits per env."""
    SL, LNp = cfg.SL, cfg.LNp
    B = rs.n_l.shape[-1]
    uni, lc = cfg.uniform, cfg.lane_change
    if lc != (best_ex is not None) or lc != (best_val is not None):
        raise ValueError("ring_admit: best_ex / best_val go with lane "
                         "change, and only with it")
    if uni != ("tpl" not in q) or uni != (rs.l_tpl is None) \
            or lc != (rs.l_off is not None):
        raise ValueError("ring_admit: the state's and the queues' optional "
                         "leaves do not match the config")
    cpu = rs.n_l.device.type == "cpu"
    i32 = (torch.int32,)
    qs = [q[k] for k in _QKEYS if k in q]
    leaves = _leaves(cfg, rs)
    _lib.check_args("ring_admit", rs.step, best_ex, best_val, *qs, *leaves,
                    dtypes=[i32, (torch.bool,), (F32,)] + [i32] * len(qs)
                    + [(l.dtype,) for l in leaves], cuda=not cpu)
    EL = net["el_lane"].shape[0]
    for t in qs:
        if t.dim() != 2 or t.shape[0] != EL:
            raise ValueError(f"ring_admit: queue {tuple(t.shape)}")
    if tuple(rs.n_l.shape) != (LNp, B) \
            or tuple(rs.el_cursor.shape) != (EL, B) \
            or tuple(rs.l_dis.shape) != (SL, LNp, B):
        raise ValueError("ring_admit: state shapes")
    if cpu:
        return ring_admit_plain(cfg, net, rs, q, best_ex, best_val)
    return _launch(cfg, net, rs, q, best_ex, best_val)


def _launch(cfg, net, rs, q, best_ex, best_val):
    global launches, launches_lc, launches_tpl
    B = rs.n_l.shape[-1]
    EL = net["el_lane"].shape[0]
    dev = rs.n_l.device
    p = cfg.params
    uni, lc = cfg.uniform, cfg.lane_change
    NR, RLEN, MAXLPR = net["route_next"].shape
    adm = torch.empty((EL, B), dtype=torch.uint8, device=dev)
    ov = torch.zeros((B,), dtype=I32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    qp = [ptr(q.get(k)) for k in _QKEYS]
    nets = [net[k].data_ptr() for k in (
        "el_lane", "ln_llocal", "route_next", "route_aux", "route_len",
        "lk_end_lane", "ln_len", "lk_len", "tpl_params")]
    lv = [ptr(getattr(rs, k)) for k in ADMIT_FIELDS]
    a = _Args(*qp, rs.step.data_ptr(), *nets, ptr(best_ex), ptr(best_val),
              *lv, adm.data_ptr(), ov.data_ptr(),
              EL, q["step"].shape[1], cfg.SL, cfg.LNp, cfg.LKp, B, NR, RLEN,
              MAXLPR, net["tpl_params"].shape[0],
              *((p[P_SPEED], p[P_LEN], p[P_LEN] + p[P_MINGAP],
                 leader_scan_bound(p[P_MAXSPEED], p[P_USUALNEGACC],
                                   cfg.interval)) if uni
                else (0.0, 0.0, 0.0, 0.0)), cfg.interval)
    _lib.check(_lib.lib().ring_admit(ctypes.byref(a), _lib.stream_ptr(ov)),
               "ring_admit")
    launches += 1
    launches_lc += int(lc)
    launches_tpl += int(not uni)
    return ov
