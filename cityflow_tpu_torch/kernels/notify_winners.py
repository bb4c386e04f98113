"""R1 notify_winners: each cross's notifier and its canPass terms, and the
blocker-cycle flag of each link, written as the foe exchange's input
(csrc/notify_winners.cu).

Engine::threadNotifyCross (engine.cpp:317-372) on the ring layout. For
every cross c of every link (l, g) and env b, the notifier is, first, the
end-lane tail when it is on this link and its tail has not reached the
cross (e_elig); else the ring slot `cnt`, the count of occupied link-ring
slots whose tail k_dis - len lies past the cross, when that slot is
occupied (ring_hit); else the start lane's head when it heads into this
link and the link is open (use_start). From the notifier: its distance
to the cross, can_yield, reach_steps (at most 255) and whether its tail
has cleared the cross, with its own template's parameters under
non-uniform templates. The blocker-cycle flag: blk followed k_cyc more
hops along the link axis of its intersection, -1 absorbing and an index
outside [0, LPI) giving -1, still >= 0.

Inputs: the link rings k_dis / k_speed / k_entll / k_pri (and k_tpl)
(SK, LKp, B), n_k and blk (LKp, B), the end-lane tail bundle `et` and the
start-lane head bundle `st` as the step's exchanges give them ((C, LKp, B)
float32: et = dis, prev, speed, pri hi, pri lo, exists [, tpl]; st = dis,
nxt, speed, pri hi, pri lo, occupied, in-lane length [, tpl]), avail_lk
(LPI, G, B) bool. Returns (9, KC * LKp, B) float32: exists, yield,
cleared, cycle, reach, distance, enter time, pri hi, pri lo.
"""

import ctypes

import torch

from cityflow_tpu_torch.compiler.net import (
    P_LEN, P_MAXNEGACC, P_MAXSPEED, P_TURNSPEED, P_USUALPOSACC, P_YIELD)
from cityflow_tpu_torch.core.numerics import xla_f32_to_i32
from cityflow_tpu_torch.core.step import can_yield, reach_steps
from cityflow_tpu_torch.kernels import _lib
from cityflow_tpu_torch.kernels.tpl_params import tpl_params_plain

launches = 0
launches_tpl = 0       # of those, with non-uniform templates
ENT_BIG = float(1 << 25)
NFIELD = 9


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "k_dis", "k_speed", "k_entll", "k_pri", "k_tpl", "n_k", "blk", "et",
        "st", "avail", "lk_d", "lk_len", "lk_turn", "table", "out")] \
        + [(n, ctypes.c_longlong) for n in (
            "SK", "LPI", "G", "KC", "LNp", "B", "TP", "k_cyc")] \
        + [(n, ctypes.c_float) for n in (
            "p_len", "p_maxneg", "p_yield", "p_turnspd", "p_maxspd",
            "p_upa", "dt")]


def notify_winners_plain(cfg, net, k_dis, k_speed, k_entll, k_pri, n_k, blk,
                         et, st, avail_lk, k_tpl=None):
    """Plain PyTorch version (the ring step's notify region as it stood
    inline, JAX ring.py:789-879)."""
    SK, LPI, G, KC, LNp, LKp = (cfg.SK, cfg.LPI, cfg.G, cfg.KC, cfg.LNp,
                                cfg.LKp)
    B = n_k.shape[-1]
    dev = n_k.device
    uni = cfg.uniform
    p_len = cfg.params[P_LEN]
    kc = net["ring_f32"]
    F = lambda i: kc[i]
    dt = kc[len(cfg.params)]
    tpp = None if uni else net["tpl_params"]
    et = et.reshape(-1, LPI, G, B)
    st = st.reshape(-1, LPI, G, B)
    end_tail_dis, end_tail_speed = et[0], et[2]
    end_tail_prev = xla_f32_to_i32(et[1])
    end_tail_prih, end_tail_pril = et[3], et[4]
    end_tail_exists = et[5] > 0.5
    st_head_dis, st_head_speed = st[0], st[2]
    st_head_nxt = xla_f32_to_i32(st[1])
    st_head_prih, st_head_pril = st[3], st[4]
    st_head_occ = st[5] > 0.5
    st_len = st[6]
    if not uni:
        end_tail_tpl = xla_f32_to_i32(et[6])
        end_tail_len = tpl_params_plain(end_tail_tpl, tpp, (P_LEN,))[0]
        st_head_tpl = xla_f32_to_i32(st[7])
    lk_id = (LNp + torch.arange(LKp, dtype=torch.int32, device=dev)) \
        .reshape(LPI, G, 1)
    lk_len = net["lk_len"].reshape(LPI, G, 1)
    lk_turn = net["lk_turn"].reshape(LPI, G, 1)

    d = net["lk_d"].reshape(KC, LPI, G, 1)
    kdis3 = k_dis.reshape(SK, LPI, G, B)
    kspd3 = k_speed.reshape(SK, LPI, G, B)
    kent3 = k_entll.reshape(SK, LPI, G, B)
    kpri3 = k_pri.reshape(SK, LPI, G, B)
    occ_k3 = (torch.arange(SK, device=dev)[:, None, None] < n_k[None]) \
        .reshape(SK, LPI, G, B)
    n_k3 = n_k.reshape(LPI, G, B)
    if not uni:
        k_tpl3 = k_tpl.reshape(SK, LPI, G, B)
        k_len3 = tpl_params_plain(k_tpl3, tpp, (P_LEN,))[0]  # own lengths

    # candidates = occupied slots whose tail has not cleared the cross;
    # tails decrease along the ring, so the winner is slot `cnt`
    cnt = torch.zeros((KC, LPI, G, B), dtype=torch.int32, device=dev)
    for s in range(SK):
        tail = kdis3[s] - (p_len if uni else k_len3[s])
        cnt += (occ_k3[s][None] & (tail[None] > d)).to(torch.int32)
    ring_hit = cnt < n_k3[None]

    e_ok = end_tail_exists & (end_tail_prev == lk_id)
    p_e = lk_len + end_tail_dis
    t_e = p_e - (p_len if uni else end_tail_len)
    e_elig = e_ok[None] & (t_e[None] < d)
    s_ok = st_head_occ & (st_head_nxt == lk_id) & avail_lk
    p_s = st_head_dis - st_len

    # winner channels: the ring-hit slot, gathered per cross
    widx = cnt.clamp(max=SK - 1).long()

    def wsel(x3):
        return torch.where(ring_hit, torch.gather(x3, 0, widx), 0.0)
    w_p = wsel(kdis3)
    w_speed = wsel(kspd3)
    w_entf = wsel(torch.clamp_max(kent3, 1 << 25).to(torch.float32))
    kprih, kpril = (kpri3 >> 16).to(torch.float32), \
        (kpri3 & 0xFFFF).to(torch.float32)
    w_prih = wsel(kprih)
    w_pril = wsel(kpril)
    use_start = ~e_elig & ~ring_hit & s_ok[None]
    w_p = torch.where(use_start, p_s[None], w_p)
    w_speed = torch.where(use_start, st_head_speed[None], w_speed)
    w_entf = torch.where(use_start, ENT_BIG, w_entf)
    w_prih = torch.where(use_start, st_head_prih[None], w_prih)
    w_pril = torch.where(use_start, st_head_pril[None], w_pril)
    w_p = torch.where(e_elig, p_e[None], w_p)
    w_speed = torch.where(e_elig, end_tail_speed[None], w_speed)
    w_entf = torch.where(e_elig, ENT_BIG, w_entf)
    w_prih = torch.where(e_elig, end_tail_prih[None], w_prih)
    w_pril = torch.where(e_elig, end_tail_pril[None], w_pril)
    exists = e_elig | ring_hit | use_start

    ndist = d - w_p
    if uni:
        n_yield = can_yield(w_speed, F(P_MAXNEGACC), F(P_YIELD), F(P_LEN),
                            ndist)
        n_target = torch.where(lk_turn[None], F(P_TURNSPEED), F(P_MAXSPEED))
        n_reach = reach_steps(w_speed, ndist, n_target, F(P_USUALPOSACC), dt)
        n_cleared = ndist + p_len < 0
    else:
        # the notifying vehicle's own parameters (Cross::notify keeps the
        # notifier; canPass reads its reach / yield, roadnet.cpp:595-660)
        w_tpl = torch.where(ring_hit, torch.gather(k_tpl3, 0, widx), 0)
        w_tpl = torch.where(use_start, st_head_tpl[None], w_tpl)
        w_tpl = torch.where(e_elig, end_tail_tpl[None], w_tpl)
        pp_w = dict(zip(
            (P_MAXNEGACC, P_YIELD, P_LEN, P_TURNSPEED, P_MAXSPEED,
             P_USUALPOSACC),
            tpl_params_plain(w_tpl, tpp, (P_MAXNEGACC, P_YIELD, P_LEN,
                                          P_TURNSPEED, P_MAXSPEED,
                                          P_USUALPOSACC))))
        n_yield = can_yield(w_speed, pp_w[P_MAXNEGACC], pp_w[P_YIELD],
                            pp_w[P_LEN], ndist)
        n_target = torch.where(lk_turn[None], pp_w[P_TURNSPEED],
                               pp_w[P_MAXSPEED])
        n_reach = reach_steps(w_speed, ndist, n_target, pp_w[P_USUALPOSACC],
                              dt)
        n_cleared = ndist + pp_w[P_LEN] < 0

    # blocker-cycle flag, link granularity (fast-mode stand-in for
    # Cross::canPass Floyd cycle detection, roadnet.cpp:662-674): k_cyc
    # hops of a gather along the link axis
    blk3 = blk.reshape(LPI, G, B)
    fcur = blk3
    for _ in range(cfg.k_cyc):
        in_rng = (fcur >= 0) & (fcur < LPI)
        f2 = torch.gather(blk3, 0, fcur.clamp(0, LPI - 1).long())
        fcur = torch.where(in_rng, f2, -1)
    cyc_link = fcur >= 0

    fields = torch.stack([
        exists.to(torch.float32), n_yield.to(torch.float32),
        n_cleared.to(torch.float32),
        cyc_link[None].to(torch.float32).expand(KC, LPI, G, B),
        torch.clamp_max(n_reach, 255).to(torch.float32),
        ndist, w_entf, w_prih, w_pril])
    return fields.reshape(NFIELD, KC * LKp, B)


def notify_winners(cfg, net, k_dis, k_speed, k_entll, k_pri, n_k, blk, et,
                   st, avail_lk, k_tpl=None):
    """R1 on CUDA tensors, the plain version on CPU tensors."""
    SK, LKp = cfg.SK, cfg.LKp
    B = n_k.shape[-1]
    uni = cfg.uniform
    if uni != (k_tpl is None):
        raise ValueError("notify_winners: k_tpl goes with non-uniform "
                         "templates, and only with them")
    cpu = n_k.device.type == "cpu"
    f32, i32, b8 = (torch.float32,), (torch.int32,), (torch.bool,)
    _lib.check_args("notify_winners", k_dis, k_speed, k_entll, k_pri, k_tpl,
                    n_k, blk, et, st, avail_lk,
                    dtypes=[f32, f32, i32, i32, i32, i32, i32, f32, f32, b8],
                    cuda=not cpu)
    for t in (k_dis, k_speed, k_entll, k_pri, k_tpl):
        if t is not None and tuple(t.shape) != (SK, LKp, B):
            raise ValueError(f"notify_winners: ring {tuple(t.shape)}")
    for t in (n_k, blk):
        if tuple(t.shape) != (LKp, B):
            raise ValueError(f"notify_winners: {tuple(t.shape)} != "
                             f"{(LKp, B)}")
    if tuple(et.shape) != (6 + (not uni), LKp, B) \
            or tuple(st.shape) != (7 + (not uni), LKp, B):
        raise ValueError(f"notify_winners: et {tuple(et.shape)}, st "
                         f"{tuple(st.shape)}")
    if avail_lk.numel() != LKp * B:
        raise ValueError(f"notify_winners: avail {tuple(avail_lk.shape)}")
    if cpu:
        return notify_winners_plain(cfg, net, k_dis, k_speed, k_entll, k_pri,
                                    n_k, blk, et, st, avail_lk, k_tpl)
    return _launch(cfg, net, k_dis, k_speed, k_entll, k_pri, n_k, blk, et,
                   st, avail_lk, k_tpl)


def _launch(cfg, net, k_dis, k_speed, k_entll, k_pri, n_k, blk, et, st,
            avail_lk, k_tpl):
    global launches, launches_tpl
    B = n_k.shape[-1]
    p = cfg.params
    table = net["tpl_params"]
    out = torch.empty((NFIELD, cfg.KC * cfg.LKp, B), dtype=torch.float32,
                      device=n_k.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    a = _Args(k_dis.data_ptr(), k_speed.data_ptr(), k_entll.data_ptr(),
              k_pri.data_ptr(), ptr(k_tpl), n_k.data_ptr(), blk.data_ptr(),
              et.data_ptr(), st.data_ptr(), avail_lk.data_ptr(),
              net["lk_d"].data_ptr(), net["lk_len"].data_ptr(),
              net["lk_turn"].data_ptr(), table.data_ptr(), out.data_ptr(),
              cfg.SK, cfg.LPI, cfg.G, cfg.KC, cfg.LNp, B, table.shape[0],
              cfg.k_cyc, *(0.0 if k_tpl is not None else p[i] for i in (
                  P_LEN, P_MAXNEGACC, P_YIELD, P_TURNSPEED, P_MAXSPEED,
                  P_USUALPOSACC)), cfg.interval)
    _lib.check(_lib.lib().notify_winners(ctypes.byref(a), _lib.stream_ptr(n_k)),
               "notify_winners")
    launches += 1
    launches_tpl += int(k_tpl is not None)
    return out
