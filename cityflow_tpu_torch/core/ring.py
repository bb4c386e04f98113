"""Gen-2 ring-layout step in PyTorch: vehicle attributes stored per
drivable, the trailing axis of every state leaf is the env batch B.

A port of the JAX package's core/ring.py, main-path branches only: uniform
vehicle parameters, no lane change, no DURATION history (ring_sim.build_sim
refuses the others). Each phase mirrors the reference (engine.cpp /
vehicle.cpp / roadnet.cpp) through the same formulas in the same float32
operation order as the JAX version.

Where the JAX version applies a one-hot operator with an einsum, this one
gathers through the index tables of compiler/ring_net.index_tables (K1,
kernels/gather_rows.py). Cross::canPass runs in K2 (kernels/cross_caps.py),
the car-following min-rule in K3 (kernels/car_follow.py), and both ring
commits in K4 (kernels/ring_commit.py). On a CPU tensor each of those
takes its plain PyTorch version; the rest of the step is plain PyTorch on
whatever device the state lives on.

Layout: lane rings (SL, LNp, B), link rings (SK, LKp, B) with
LNp = OL * I and LKp = LPI * G; B is contiguous, so neighbouring threads of
a kernel touch neighbouring envs. Integer channels that cross a float
exchange stay exact: priorities ride as (hi, lo) 16-bit halves, enter times
as min(t, 2^25), uids/routes/flows are < 2^24; every float -> int32
conversion is XLA's saturating one (core/numerics.xla_f32_to_i32).
"""

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from cityflow_tpu_torch.core.numerics import jnp_take, xla_f32_to_i32
from cityflow_tpu_torch.core.state import (
    INT_MAX, OV_HOPS, OV_LINK_TABLE, OV_REMOVE, OV_SLOTS)
from cityflow_tpu_torch.core.step import can_yield, reach_steps
from cityflow_tpu_torch.kernels.car_follow import car_follow
from cityflow_tpu_torch.kernels.cross_caps import cross_caps
from cityflow_tpu_torch.kernels.gather_rows import gather_rows
from cityflow_tpu_torch.kernels.ring_commit import ring_commit

P_SPEED, P_LEN, P_WIDTH, P_MAXPOSACC, P_MAXNEGACC, P_USUALPOSACC, \
    P_USUALNEGACC, P_MINGAP, P_MAXSPEED, P_HEADWAY, P_YIELD, P_TURNSPEED = range(12)

ENT_BIG = float(1 << 25)
F32 = torch.float32
I32 = torch.int32


@dataclass(frozen=True)
class RingConfig:
    interval: float
    I: int; G: int; T: int
    LPI: int; OL: int; IL: int; KC: int; KIN: int; KOUT: int
    LNp: int; LKp: int
    SL: int = 16
    SK: int = 10
    AP: int = 2               # lane front slots computed in the link domain
    XK: int = 2               # max front departures per drivable per step
    SA: int = 4               # max appends per lane per step
    TI: int = 12              # compacted link->lane transfers per
                              # intersection per step (overflow-flagged)
    type_ranges: Tuple[Tuple[int, int], ...] = ()
    params: Tuple[float, ...] = ()
    rl_traffic_light: bool = False
    k_phase: int = 8
    k_cyc: int = 4
    SKC: int = 99             # link ring slots that evaluate Cross::canPass
    MAXLPR: int = 1           # route-table lanes-per-road width


STATE_FIELDS = ("step", "finished_cnt", "cum_travel", "overflow",
                "n_l", "n_k", "el_cursor", "phase", "phase_remain", "blk",
                "l_dis", "l_speed", "l_flow", "l_route", "l_rpos",
                "l_nxt", "l_nxt3", "l_prev", "l_enter", "l_pri",
                "l_uid", "l_last", "l_custom", "l_hascustom",
                "k_dis", "k_speed", "k_flow", "k_route", "k_rpos",
                "k_entll", "k_enter", "k_pri", "k_uid", "k_nxtl",
                "k_custom", "k_hascustom")
FLOAT_FIELDS = frozenset({"cum_travel", "phase_remain", "l_dis", "l_speed",
                          "l_enter", "l_custom", "k_dis", "k_speed",
                          "k_enter", "k_custom"})
BOOL_FIELDS = frozenset({"l_last", "l_hascustom", "k_hascustom"})


@dataclass
class RingState:
    """Dynamic state. Unbatched leaves have the JAX package's shapes;
    batched ones (batch_ring_state) carry a trailing env axis B."""
    step: Any
    finished_cnt: Any
    cum_travel: Any
    overflow: Any
    n_l: Any                  # (LNp,) i32 occupied lane slots (front prefix)
    n_k: Any                  # (LKp,) i32
    el_cursor: Any            # (EL,) i32 next spawn-queue row per entry lane
    phase: Any                # (I,) i32 (ring intersection order)
    phase_remain: Any         # (I,) f32
    blk: Any                  # (LKp,) i32 blocker foe-lpi per link (-1)
    l_dis: Any; l_speed: Any; l_flow: Any; l_route: Any; l_rpos: Any
    l_nxt: Any; l_nxt3: Any; l_prev: Any; l_enter: Any; l_pri: Any
    l_uid: Any; l_last: Any; l_custom: Any; l_hascustom: Any
    k_dis: Any; k_speed: Any; k_flow: Any; k_route: Any; k_rpos: Any
    k_entll: Any; k_enter: Any; k_pri: Any; k_uid: Any; k_nxtl: Any
    k_custom: Any; k_hascustom: Any

    def replace_fields(self, **kw):
        return dataclasses.replace(self, **kw)

    def leaves(self):
        return {k: getattr(self, k) for k in STATE_FIELDS}

    def map(self, fn):
        return RingState(**{k: fn(v) for k, v in self.leaves().items()})


def init_ring_state(cfg: RingConfig, net, num_entry: int,
                    device) -> RingState:
    """Initial single-env state (no batch axis). `net` holds the host
    (numpy) tables."""
    SL, SK, LNp, LKp = cfg.SL, cfg.SK, cfg.LNp, cfg.LKp
    kw = dict(device=device)
    zl = lambda: torch.zeros((SL, LNp), dtype=F32, **kw)
    il_ = lambda v=0: torch.full((SL, LNp), v, dtype=I32, **kw)
    zk = lambda: torch.zeros((SK, LKp), dtype=F32, **kw)
    ik = lambda v=0: torch.full((SK, LKp), v, dtype=I32, **kw)
    n_ph = np.asarray(net["i_n_phases"])
    off = np.asarray(net["i_phase_offset"])
    pt = np.asarray(net["phase_time"])
    first = pt[np.clip(off, 0, len(pt) - 1)]
    remain = torch.as_tensor(np.where(n_ph > 0, first, 0.0)
                             .astype(np.float32), **kw)
    scalar = lambda v, dt: torch.tensor(v, dtype=dt, **kw)
    return RingState(
        step=scalar(0, I32), finished_cnt=scalar(0, I32),
        cum_travel=scalar(0.0, F32), overflow=scalar(0, I32),
        n_l=torch.zeros(LNp, dtype=I32, **kw),
        n_k=torch.zeros(LKp, dtype=I32, **kw),
        el_cursor=torch.zeros(num_entry, dtype=I32, **kw),
        phase=torch.zeros(cfg.I, dtype=I32, **kw), phase_remain=remain,
        blk=torch.full((LKp,), -1, dtype=I32, **kw),
        l_dis=zl(), l_speed=zl(), l_flow=il_(), l_route=il_(), l_rpos=il_(),
        l_nxt=il_(-1), l_nxt3=il_(-1), l_prev=il_(-1), l_enter=zl(),
        l_pri=il_(), l_uid=il_(-1),
        l_last=torch.zeros((SL, LNp), dtype=torch.bool, **kw),
        l_custom=zl(),
        l_hascustom=torch.zeros((SL, LNp), dtype=torch.bool, **kw),
        k_dis=zk(), k_speed=zk(), k_flow=ik(), k_route=ik(), k_rpos=ik(),
        k_entll=ik(INT_MAX), k_enter=zk(), k_pri=ik(), k_uid=ik(-1),
        k_nxtl=ik(-1), k_custom=zk(),
        k_hascustom=torch.zeros((SK, LKp), dtype=torch.bool, **kw))


def batch_ring_state(st: RingState, B: int) -> RingState:
    """Replicate a single-env RingState into the trailing-batch layout
    consumed by ring_step_*_batched (leaves become shape + (B,))."""
    return st.map(lambda x: x[..., None].expand(*x.shape, B).contiguous())


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _hilo(pri):
    return (pri >> 16).to(F32), (pri & 0xFFFF).to(F32)


def _from_hilo(h, l):
    return (xla_f32_to_i32(h) << 16) | xla_f32_to_i32(l)


def _any_env(x):
    """Reduce every axis but the trailing env axis with any()."""
    return x.reshape(-1, x.shape[-1]).any(dim=0)


def _flag(cond, bit):
    return cond.to(I32) * bit


def _sel_slot(x, n):
    """x[n - 1] per column and env, 0 where the ring is empty
    ((S, N, B), (N, B) -> (N, B))."""
    got = torch.gather(x, 0, (n - 1).clamp(min=0).long()[None])[0]
    return torch.where(n > 0, got, torch.zeros_like(got))


def _shift_in(first, x):
    """Leader view of a ring: [first, x[0], ..., x[S-2]] along the slots."""
    return torch.cat([first, x[:-1]], dim=0)


def ring_constants(cfg: RingConfig, device):
    """cfg.params then cfg.interval as one float32 tensor on the device:
    the step slices its JAX f(p) constants out of it, so no step copies a
    scalar to the card (carry.tables_from_numpy stores it as
    net["ring_f32"])."""
    return torch.tensor(tuple(cfg.params) + (cfg.interval,), dtype=F32,
                        device=device)


class _Ctx:
    """Per-call constants: the config's scalars as float32 0-dim tensors
    (JAX's f(p) constants, views of net["ring_f32"]), the kernels' scalar
    parameters as Python floats, and the tables."""

    def __init__(self, net, cfg, dev):
        self.net, self.cfg, self.dev = net, cfg, dev
        k = net["ring_f32"]
        self.F = lambda i: k[i]
        self.dt = k[len(cfg.params)]
        p = cfg.params
        self.prm_cc = (p[P_MAXNEGACC], p[P_YIELD], p[P_LEN], p[P_TURNSPEED],
                       p[P_MAXSPEED], p[P_USUALPOSACC], cfg.interval)
        self.prm_cf = (p[P_MAXSPEED], p[P_TURNSPEED], p[P_USUALPOSACC],
                       p[P_USUALNEGACC], p[P_YIELD], p[P_MAXNEGACC],
                       p[P_MINGAP], p[P_HEADWAY], p[P_MAXPOSACC],
                       cfg.interval)
        self.cc_tabs = dict(d=net["lk_d"], cvalid=net["lk_cvalid"],
                            t2=net["lk_foetype"], foelpi=net["lk_foelpi"],
                            t1=net["lk_type"], turn=net["lk_turn"])

    def lpi_of(self, nxt_ids):
        """(IL, G, B) next-link ids -> local link index (or -1)."""
        cfg = self.cfg
        g = torch.arange(cfg.G, dtype=I32, device=self.dev)[None, :, None]
        return torch.where(nxt_ids >= 0, torch.div(
            nxt_ids - cfg.LNp - g, cfg.G, rounding_mode="floor"), -1)

    def to_link_idx(self, lpi_h):
        """Dynamic K1 index of to_link: link (l, g) takes the front of its
        start in-lane iff that front's next link is l."""
        cfg = self.cfg
        src = self.net["start_src"].long()                      # (LKp,)
        B = lpi_h.shape[-1]
        lp = lpi_h.reshape(cfg.IL * cfg.G, B)[src.clamp(min=0)]  # (LKp, B)
        l_of = torch.arange(cfg.LKp, device=self.dev) // cfg.G
        ok = (src >= 0)[:, None] & (lp == l_of[:, None])
        return torch.where(ok, src[:, None], -1).to(I32)

    def from_link_idx(self, lpi_h):
        """Dynamic K1 index of from_link: in-lane (i, g) reads link
        lpi_h[i, g] of its intersection."""
        cfg = self.cfg
        g = torch.arange(cfg.G, dtype=I32, device=self.dev)[None, :, None]
        ok = (lpi_h >= 0) & (lpi_h < cfg.LPI)
        return torch.where(ok, lpi_h * cfg.G + g, -1) \
            .reshape(cfg.IL * cfg.G, -1).to(I32).contiguous()


def _front_views(cfg, inl):
    """Decode the in-lane view of the forward exchange (JAX ap_ch)."""
    AP = cfg.AP
    ch = lambda c: inl[c * AP:(c + 1) * AP]
    v = dict(dis=ch(0), speed=ch(1), nxt=xla_f32_to_i32(ch(2)),
             nxt3=xla_f32_to_i32(ch(3)), route=xla_f32_to_i32(ch(4)),
             rpos=xla_f32_to_i32(ch(5)), flow=xla_f32_to_i32(ch(6)),
             prih=ch(7), pril=ch(8), uid=xla_f32_to_i32(ch(9)),
             enter=ch(10), custom=ch(11), hascustom=ch(12) > 0,
             occ_raw=ch(13) > 0)
    NFC = (inl.shape[0] - 2) // AP
    v["il_len"] = inl[NFC * AP]
    v["il_maxspd"] = inl[NFC * AP + 1]
    return v


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _notify_phase(net, cfg: RingConfig, rs: RingState, q,
                  debug: bool = False):
    """One Engine::nextStep (engine.cpp:566-594) up to the speed decisions,
    on trailing-batch state; `q` = per-entry-lane spawn queues (host
    mt19937 replay), shared by all envs. Returns (rs, mid, dbg)."""
    dbg = {}
    dev = rs.n_l.device
    B = rs.n_l.shape[-1]
    cx = _Ctx(net, cfg, dev)
    F, dt = cx.F, cx.dt
    SL, SK, LNp, LKp = cfg.SL, cfg.SK, cfg.LNp, cfg.LKp
    G, LPI, KC, IL, AP = cfg.G, cfg.LPI, cfg.KC, cfg.IL, cfg.AP
    ov = rs.overflow
    prm = cfg.params
    p_speed0, p_len, p_una = prm[P_SPEED], prm[P_LEN], prm[P_USUALNEGACC]
    p_mingap, p_maxspd = prm[P_MINGAP], prm[P_MAXSPEED]
    approach = p_maxspd * p_maxspd / p_una / 2 + p_maxspd * cfg.interval * 2

    # =====================================================================
    # 1. spawn + admission (Flow::nextStep + Engine::handleWaiting,
    #    engine.cpp:502-516)
    # =====================================================================
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
    avail_e = (n_e == 0) | (t_dis > p_len + p_mingap)
    admit = has_row & avail_e & (n_e < SL)
    ov = ov | _flag(_any_env(has_row & avail_e & (n_e >= SL)), OV_SLOTS)

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

    # spread entry-lane values to the lane axis (K1 through el_src)
    pri_h0, pri_l0 = _hilo(row["pri"])
    sp_in = [admit.to(F32)] + [
        torch.where(admit, v.to(F32), 0.0)
        for v in (row["flow"], rt, nxt0, nxt3_0, pri_h0, pri_l0, row["uid"],
                  last0, row["step"])]
    sp = gather_rows(torch.stack(sp_in), net["el_src"], 0.0)    # (10,LNp,B)
    adm_lane = sp[0] > 0.5
    sl_idx = torch.arange(SL, device=dev)[:, None, None]
    place = adm_lane[None] & (sl_idx == rs.n_l[None])

    def put(a, dense_v):
        v = dense_v if a.dtype == F32 else xla_f32_to_i32(dense_v)
        return torch.where(place, v[None], a)

    def putc(a, const):
        return torch.where(place, const, a)

    rs = rs.replace_fields(
        l_dis=putc(rs.l_dis, 0.0),
        l_speed=putc(rs.l_speed, p_speed0),
        l_flow=put(rs.l_flow, sp[1]),
        l_route=put(rs.l_route, sp[2]),
        l_rpos=putc(rs.l_rpos, 0),
        l_nxt=put(rs.l_nxt, sp[3]), l_nxt3=put(rs.l_nxt3, sp[4]),
        l_prev=putc(rs.l_prev, -1),
        # enterTime is the SPAWN step (Vehicle ctor at Flow::nextStep)
        l_enter=put(rs.l_enter, sp[9] * dt),
        l_pri=torch.where(place, _from_hilo(sp[5], sp[6])[None], rs.l_pri),
        l_uid=put(rs.l_uid, sp[7]),
        l_last=torch.where(place, (sp[8] > 0.5)[None], rs.l_last),
        l_custom=putc(rs.l_custom, 0.0),
        l_hascustom=putc(rs.l_hascustom, False),
        n_l=rs.n_l + adm_lane.to(I32),
        el_cursor=rs.el_cursor + admit.to(I32))

    # =====================================================================
    # 2. views
    # =====================================================================
    sk_idx = torch.arange(SK, device=dev)[:, None, None]
    occ_l = sl_idx < rs.n_l[None]
    occ_k = sk_idx < rs.n_k[None]

    # lane tail bundle (rear vehicle; link end-specials + canEnter)
    tl_dis = _sel_slot(rs.l_dis, rs.n_l)
    tl_prev = _sel_slot(rs.l_prev, rs.n_l)
    tl_speed = _sel_slot(rs.l_speed, rs.n_l)
    tl_prih, tl_pril = _hilo(_sel_slot(rs.l_pri, rs.n_l))
    tl_exists = rs.n_l > 0

    # link ring tail (overlap-rule leader candidates)
    kt_dis = _sel_slot(rs.k_dis, rs.n_k)
    kt_speed = _sel_slot(rs.k_speed, rs.n_k)
    kt_exists = rs.n_k > 0

    # forward exchange: lane-front bundles -> (AP, IL, G) in-lane view
    prih_l, pril_l = _hilo(rs.l_pri[:AP])
    fch = [rs.l_dis[:AP], rs.l_speed[:AP],
           rs.l_nxt[:AP].to(F32), rs.l_nxt3[:AP].to(F32),
           rs.l_route[:AP].to(F32), rs.l_rpos[:AP].to(F32),
           rs.l_flow[:AP].to(F32), prih_l, pril_l,
           rs.l_uid[:AP].to(F32), rs.l_enter[:AP],
           rs.l_custom[:AP], rs.l_hascustom[:AP].to(F32),
           occ_l[:AP].to(F32)]
    NFC = len(fch)
    fwd = torch.cat([torch.stack(fch).reshape(NFC * AP, LNp, B),
                     net["ln_len"][None, :, None].expand(1, LNp, B),
                     net["ln_maxspd"][None, :, None].expand(1, LNp, B)])
    in_src = net["in_src"].reshape(-1)
    src_ok = (in_src >= 0).reshape(IL, G)[None, :, :, None]
    inl = gather_rows(fwd, in_src, 0.0).reshape(-1, IL, G, B)
    h = _front_views(cfg, inl)
    h_dis, h_speed, h_nxt = h["dis"], h["speed"], h["nxt"]
    h_prih, h_pril = h["prih"], h["pril"]
    h_occ = h["occ_raw"] & src_ok
    il_len, il_maxspd = h["il_len"], h["il_maxspd"]

    # =====================================================================
    # 3. link domain
    # =====================================================================
    ph_row = net["g_phase_offset"][:, None] + rs.phase[:G].clamp(min=0)
    pra = net["phase_rl_avail"]
    avail_rows = pra[ph_row.clamp(0, pra.shape[0] - 1).long()]  # (G,B,MAXRL)
    MAXRL = pra.shape[1]
    avail_lk = gather_rows(
        avail_rows.permute(2, 0, 1).reshape(1, MAXRL * G, B),
        net["rl_src"], 0.0).reshape(LPI, G, B) > 0.5

    lk_id = (LNp + torch.arange(LKp, dtype=I32, device=dev)) \
        .reshape(LPI, G, 1)
    lk_len = net["lk_len"].reshape(LPI, G, 1)
    lk_turn = net["lk_turn"].reshape(LPI, G, 1)

    # end-lane tail bundle per link (E_end after the (OL, I) lane view)
    et = gather_rows(torch.stack([
        tl_dis, tl_prev.to(F32), tl_speed, tl_prih, tl_pril,
        tl_exists.to(F32)]), net["end_src"], 0.0).reshape(6, LPI, G, B)
    end_tail_dis = et[0]
    end_tail_prev = xla_f32_to_i32(et[1])
    end_tail_speed = et[2]
    end_tail_prih, end_tail_pril = et[3], et[4]
    end_tail_exists = et[5] > 0.5

    # start-lane head bundle per link (E_start)
    st = gather_rows(torch.stack([
        h_dis[0], h_nxt[0].to(F32), h_speed[0], h_prih[0], h_pril[0],
        h_occ[0].to(F32), il_len]).reshape(7, IL * G, B),
        net["start_src"], 0.0).reshape(7, LPI, G, B)
    st_head_dis = st[0]
    st_head_nxt = xla_f32_to_i32(st[1])
    st_head_speed = st[2]
    st_head_prih, st_head_pril = st[3], st[4]
    st_head_occ = st[5] > 0.5
    st_len = st[6]

    # ---- notify winners (Engine::threadNotifyCross, engine.cpp:317-372)
    d = net["lk_d"].reshape(KC, LPI, G, 1)
    kdis3 = rs.k_dis.reshape(SK, LPI, G, B)
    kspd3 = rs.k_speed.reshape(SK, LPI, G, B)
    kent3 = rs.k_entll.reshape(SK, LPI, G, B)
    kpri3 = rs.k_pri.reshape(SK, LPI, G, B)
    occ_k3 = occ_k.reshape(SK, LPI, G, B)
    n_k3 = rs.n_k.reshape(LPI, G, B)

    # candidates = occupied slots whose tail has not cleared the cross;
    # tails decrease along the ring, so the winner is slot `cnt`
    cnt = torch.zeros((KC, LPI, G, B), dtype=I32, device=dev)
    for s in range(SK):
        cnt += (occ_k3[s][None] & ((kdis3[s] - p_len)[None] > d)).to(I32)
    ring_hit = cnt < n_k3[None]

    e_ok = end_tail_exists & (end_tail_prev == lk_id)
    p_e = lk_len + end_tail_dis
    t_e = p_e - p_len
    e_elig = e_ok[None] & (t_e[None] < d)
    s_ok = st_head_occ & (st_head_nxt == lk_id) & avail_lk
    p_s = st_head_dis - st_len

    # winner channels: the ring-hit slot, gathered per cross
    widx = cnt.clamp(max=SK - 1).long()

    def wsel(x3):
        return torch.where(ring_hit, torch.gather(x3, 0, widx), 0.0)
    w_p = wsel(kdis3)
    w_speed = wsel(kspd3)
    w_entf = wsel(torch.clamp_max(kent3, 1 << 25).to(F32))
    kprih, kpril = _hilo(kpri3)
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
    n_yield = can_yield(w_speed, F(P_MAXNEGACC), F(P_YIELD), F(P_LEN),
                        ndist)
    n_target = torch.where(lk_turn[None], F(P_TURNSPEED), F(P_MAXSPEED))
    n_reach = reach_steps(w_speed, ndist, n_target, F(P_USUALPOSACC), dt)
    n_cleared = ndist + p_len < 0

    # blocker-cycle flag, link granularity (fast-mode stand-in for
    # Cross::canPass Floyd cycle detection, roadnet.cpp:662-674): pointer
    # doubling as a gather along the link axis
    blk3 = rs.blk.reshape(LPI, G, B)
    fcur = blk3
    for _ in range(cfg.k_cyc):
        in_rng = (fcur >= 0) & (fcur < LPI)
        f2 = torch.gather(blk3, 0, fcur.clamp(0, LPI - 1).long())
        fcur = torch.where(in_rng, f2, -1)
    cyc_link = fcur >= 0

    # ---- foe exchange: one exact gather of all 9 channels (K1) ----------
    fields = torch.stack([
        exists.to(F32), n_yield.to(F32), n_cleared.to(F32),
        cyc_link[None].to(F32).expand(KC, LPI, G, B),
        torch.clamp_max(n_reach, 255).to(F32),
        ndist, w_entf, w_prih, w_pril])
    foe = gather_rows(fields.reshape(9, KC * LKp, B), net["foe_src"], 0.0) \
        .reshape(9, KC, LKp, B)

    # ---- link ring rows: Cross::canPass (K2) + car following (K3) --------
    can_enter_k = (~end_tail_exists | (end_tail_dis > p_len + p_len)
                   | (end_tail_speed >= 2))
    lead_dis_k = _shift_in(torch.full((1, LKp, B), 1e9, device=dev),
                           rs.k_dis)
    gap_k = (lead_dis_k - p_len - rs.k_dis).reshape(SK, LPI, G, B)
    # front: leader = end-lane tail
    fr_gap = (lk_len - kdis3[0]) + end_tail_dis - p_len
    gap_k[0] = torch.where(end_tail_exists, fr_gap, gap_k[0])
    lead_spd_k3 = _shift_in(torch.zeros((1, LKp, B), device=dev),
                            rs.k_speed).reshape(SK, LPI, G, B)
    lead_spd_k3[0] = end_tail_speed
    has_lead_k3 = _shift_in(torch.zeros((1, LKp, B), dtype=torch.bool,
                                        device=dev), occ_k) \
        .reshape(SK, LPI, G, B)
    has_lead_k3[0] = end_tail_exists

    R = min(cfg.SKC, SK)
    af_r, fd_r, ffo_r = cross_caps(
        rs.k_dis[:R], rs.k_speed[:R],
        torch.clamp_max(rs.k_entll[:R], 1 << 25).to(F32),
        kprih[:R].reshape(R, LKp, B), kpril[:R].reshape(R, LKp, B),
        occ_k[:R], foe, cx.cc_tabs, cx.prm_cc)
    if SK > R:
        pad = lambda x, v: torch.cat(
            [x, torch.full((SK - R, LKp, B), v, dtype=x.dtype, device=dev)])
        k_fail_all = pad(af_r, False)
        k_ffd_all = pad(fd_r, 0.0)
        k_fffoe_all = pad(ffo_r, 0)
    else:
        k_fail_all, k_ffd_all, k_fffoe_all = af_r, fd_r, ffo_r
    k_fail_all = k_fail_all.reshape(SK, LPI, G, B)
    k_fffoe_all = k_fffoe_all.reshape(SK, LPI, G, B)
    ns_k3, dd_k = car_follow(
        3, cx.prm_cf, (SK, LPI, G, B),
        speed=kspd3, dls=kdis3, isr_lane_left=0.0, any_fail=k_fail_all,
        ff_d=k_ffd_all.reshape(SK, LPI, G, B), app=False, avail=avail_lk,
        can_enter=can_enter_k, turn=lk_turn, gap=gap_k,
        lead_spd=lead_spd_k3, has_lead=has_lead_k3, isr_rel=True,
        custom=rs.k_custom.reshape(SK, LPI, G, B),
        has_custom=rs.k_hascustom.reshape(SK, LPI, G, B),
        drv_maxspd=10000.0,          # LaneLink maxSpeed, roadnet.h:456
        invalid=False, lane_left=0.0)
    nd_k3 = kdis3 + dd_k

    # ---- approach rows: lane fronts computed per link then sent back ----
    # leader candidates for lane heads: ring tails of all out-links
    # (Lane::laneLinks order, strict-min on dis - len, vehicle.cpp:170-180)
    oc = gather_rows(torch.stack([kt_dis - p_len, kt_exists.to(F32),
                                  kt_speed]), net["out_src"], 0.0) \
        .reshape(3, IL, cfg.KOUT, G, B)
    oc_valid = net["out_valid_g"][..., None] > 0                # (IL,KOUT,G,1)
    best_val = torch.zeros((IL, G, B), device=dev)
    best_spd = torch.zeros((IL, G, B), device=dev)
    best_ex = torch.zeros((IL, G, B), dtype=torch.bool, device=dev)
    for k in range(cfg.KOUT):
        cand_ex = (oc[1, :, k] > 0.5) & oc_valid[:, k]
        better = cand_ex & (~best_ex | (oc[0, :, k] < best_val))
        best_val = torch.where(better, oc[0, :, k], best_val)
        best_spd = torch.where(better, oc[2, :, k], best_spd)
        best_ex = best_ex | cand_ex

    # route each lane-front slot to its next link, one batched
    # cross_caps / isr pass over all AP rows, then back (K1 both ways)
    lpi_hs = [cx.lpi_of(h_nxt[a]) for a in range(AP)]
    mine_ilgs = [h_occ[a] & (h_nxt[a] >= 0) for a in range(AP)]
    lk_ch = torch.stack([gather_rows(
        torch.stack([mine_ilgs[a].to(F32), h_dis[a], h_speed[a], h_prih[a],
                     h_pril[a]]).reshape(5, IL * G, B),
        didx=cx.to_link_idx(lpi_hs[a]), fill=0.0) for a in range(AP)])
    lk_ch = lk_ch.reshape(AP, 5, LPI, G, B)
    mine_lk = lk_ch[:, 0] > 0.5
    dis_lk, spd_lk = lk_ch[:, 1].contiguous(), lk_ch[:, 2].contiguous()
    prih_lk, pril_lk = lk_ch[:, 3].contiguous(), lk_ch[:, 4].contiguous()
    dls_ap = dis_lk - st_len[None]
    lane_left_lk = st_len[None] - dis_lk
    af_ap, fd_ap, ffo_ap = cross_caps(
        dls_ap.reshape(AP, LKp, B), spd_lk.reshape(AP, LKp, B), ENT_BIG,
        prih_lk.reshape(AP, LKp, B), pril_lk.reshape(AP, LKp, B),
        mine_lk.reshape(AP, LKp, B), foe, cx.cc_tabs, cx.prm_cc)
    af_ap = af_ap.reshape(AP, LPI, G, B)
    fd_ap = fd_ap.reshape(AP, LPI, G, B)
    ffo_ap = ffo_ap.reshape(AP, LPI, G, B)
    v_isr_ap, red_ap = car_follow(
        1, cx.prm_cf, (AP, LPI, G, B), speed=spd_lk, dls=dls_ap,
        isr_lane_left=lane_left_lk, any_fail=af_ap, ff_d=fd_ap, app=True,
        avail=avail_lk, can_enter=can_enter_k, turn=lk_turn)
    isr_rel_ap = mine_lk & (lane_left_lk <= approach)

    gl, ll, lsp, hl, vi, ir = [], [], [], [], [], []
    for a in range(AP):
        fidx = cx.from_link_idx(lpi_hs[a])
        if a == 0:
            bk = gather_rows(torch.stack([
                v_isr_ap[0], isr_rel_ap[0].to(F32), end_tail_dis,
                end_tail_exists.to(F32), end_tail_speed,
                lk_len.expand(LPI, G, B)]).reshape(6, LKp, B),
                didx=fidx, fill=0.0).reshape(6, IL, G, B)
            etd, ete, ets, nlen = bk[2], bk[3] > 0.5, bk[4], bk[5]
            lane_left_a = il_len - h_dis[0]
            gap1 = lane_left_a + best_val
            gap2 = lane_left_a + nlen + etd - p_len
            hl.append(best_ex | ete)
            gl.append(torch.where(best_ex, gap1, gap2))
            lsp.append(torch.where(best_ex, best_spd, ets))
        else:
            bk = gather_rows(torch.stack([
                v_isr_ap[a], isr_rel_ap[a].to(F32)]).reshape(2, LKp, B),
                didx=fidx, fill=0.0).reshape(2, IL, G, B)
            hl.append(h_occ[a - 1])
            gl.append(h_dis[a - 1] - p_len - h_dis[a])
            lsp.append(h_speed[a - 1])
        vi.append(bk[0])
        ir.append(bk[1] > 0.5)
        ll.append(il_len - h_dis[a])
    ap_spd, ap_dd = car_follow(
        2, cx.prm_cf, (AP, IL, G, B), speed=h_speed, gap=torch.stack(gl),
        lead_spd=torch.stack(lsp), has_lead=torch.stack(hl),
        v_isr=torch.stack(vi), isr_rel=torch.stack(ir),
        custom=h["custom"], has_custom=h["hascustom"],
        drv_maxspd=il_maxspd, invalid=False, lane_left=torch.stack(ll))
    ap_dis = h_dis + ap_dd

    # --- lane-domain dynamics for all slots, then override fronts --------
    lead_dis_l = _shift_in(torch.full((1, LNp, B), 1e9, device=dev),
                           rs.l_dis)
    lead_spd_l = _shift_in(torch.zeros((1, LNp, B), device=dev), rs.l_speed)
    has_lead_l = _shift_in(torch.zeros((1, LNp, B), dtype=torch.bool,
                                       device=dev), occ_l)
    gap_l = lead_dis_l - p_len - rs.l_dis
    lane_left_l = net["ln_len"][:, None] - rs.l_dis
    invalid_l = occ_l & (rs.l_nxt < 0) & ~rs.l_last
    new_spd_l, delta_l = car_follow(
        2, cx.prm_cf, (SL, LNp, B), speed=rs.l_speed, gap=gap_l,
        lead_spd=lead_spd_l, has_lead=has_lead_l, v_isr=0.0, isr_rel=False,
        custom=rs.l_custom, has_custom=rs.l_hascustom,
        drv_maxspd=net["ln_maxspd"][:, None], invalid=invalid_l,
        lane_left=lane_left_l)
    new_dis_l = rs.l_dis + delta_l
    ap_rel = torch.stack(mine_ilgs)
    back = torch.stack([ap_spd, ap_dis, ap_rel.to(F32)], dim=1) \
        .reshape(3 * AP, IL * G, B)
    got = gather_rows(back, net["in_inv"], 0.0)                # (3AP,LNp,B)
    has_inv = (net["in_inv"] >= 0)[:, None]
    for a in range(AP):
        use = has_inv & (got[3 * a + 2] > 0)
        new_spd_l[a] = torch.where(use, got[3 * a], new_spd_l[a])
        new_dis_l[a] = torch.where(use, got[3 * a + 1], new_dis_l[a])

    mid = dict(
        inl=inl, nd_k3=nd_k3, ns_k3=ns_k3,
        new_dis_l=new_dis_l, new_spd_l=new_spd_l,
        k_fail=k_fail_all, k_fffoe=k_fffoe_all,
        ap_spd=ap_spd, ap_dis=ap_dis,
        ap_fail=af_ap & mine_lk, ap_ffo=ffo_ap, ap_red=red_ap & mine_lk,
        ov=ov)
    if debug:
        dbg.update(k2_link=(af_r, fd_r, ffo_r), k2_ap=(af_ap, fd_ap, ffo_ap),
                   k3_link=(ns_k3, dd_k), k3_ap_isr=(v_isr_ap, red_ap),
                   k3_ap=(ap_spd, ap_dd), k3_lane=(new_spd_l, delta_l),
                   foe=foe)
    return rs, mid, dbg


def _commit_phase(net, cfg: RingConfig, rs: RingState, mid,
                  debug: bool = False):
    """Transfers, removals, ring commits, blockers and lights (the second
    half of Engine::nextStep) on trailing-batch state."""
    dev = rs.n_l.device
    B = rs.n_l.shape[-1]
    cx = _Ctx(net, cfg, dev)
    dt = cx.dt
    SL, SK, LNp, LKp = cfg.SL, cfg.SK, cfg.LNp, cfg.LKp
    G, LPI, IL, OL, AP = cfg.G, cfg.LPI, cfg.IL, cfg.OL, cfg.AP
    ov = mid["ov"]
    sl_idx = torch.arange(SL, device=dev)[:, None, None]
    sk_idx = torch.arange(SK, device=dev)[:, None, None]
    occ_l = sl_idx < rs.n_l[None]
    occ_k = sk_idx < rs.n_k[None]
    occ_k3 = occ_k.reshape(SK, LPI, G, B)
    ln_llocal = net["ln_llocal"]
    rn = net["route_next"]
    NR, RLEN, MAXLPR = rn.shape
    in_src = net["in_src"].reshape(-1)
    src_ok = (in_src >= 0).reshape(IL, G)[None, :, :, None]

    h = _front_views(cfg, mid["inl"])
    h_nxt = h["nxt"]
    h_occ = h["occ_raw"] & src_ok
    il_len = h["il_len"]
    lpi_hs = [cx.lpi_of(h_nxt[a]) for a in range(AP)]
    k_fail_all, k_fffoe_all = mid["k_fail"], mid["k_fffoe"]
    nd_k3, ns_k3 = mid["nd_k3"], mid["ns_k3"]
    new_dis_l, new_spd_l = mid["new_dis_l"], mid["new_spd_l"]
    invalid_l = occ_l & (rs.l_nxt < 0) & ~rs.l_last

    # =====================================================================
    # 4. transfers / removals / commit
    # =====================================================================
    ln_len_b = net["ln_len"][:, None]
    # invalid vehicles never cross the lane end (v_inv stops them; the
    # clamp guards fp edges so they cannot fall off the ring)
    new_dis_l = torch.where(invalid_l, torch.minimum(new_dis_l, ln_len_b),
                            new_dis_l)
    cross_l = occ_l & (new_dis_l > ln_len_b)
    pref = torch.ones((LNp, B), dtype=torch.bool, device=dev)
    leave_pref_l = []
    for s in range(min(cfg.XK, SL)):
        pref = cross_l[s] & pref
        leave_pref_l.append(pref)
    x_l = sum(c.to(I32) for c in leave_pref_l)
    if SL > cfg.XK:
        deep = cross_l[cfg.XK:] & (sl_idx[cfg.XK:] < rs.n_l[None])
        ov = ov | _flag(_any_env(deep), OV_HOPS)
    XKl = len(leave_pref_l)
    removed_l = [leave_pref_l[s] & rs.l_last[s] for s in range(XKl)]
    exited_l = [leave_pref_l[s] & ~rs.l_last[s] & (rs.l_nxt[s] >= 0)
                for s in range(XKl)]
    now = rs.step.to(F32) * dt
    tt = now - rs.l_enter
    n_rm = sum(r.to(I32).sum(0, dtype=I32) for r in removed_l)
    t_rm = sum(torch.where(removed_l[s], tt[s], 0.0).sum(0)
               for s in range(XKl))

    nd_k = nd_k3.reshape(SK, LKp, B)
    ns_k = ns_k3.reshape(SK, LKp, B)
    cross_k = occ_k & (nd_k > net["lk_len"][:, None])
    prefk = torch.ones((LKp, B), dtype=torch.bool, device=dev)
    leave_pref_k = []
    for s in range(min(cfg.XK, SK)):
        prefk = cross_k[s] & prefk
        leave_pref_k.append(prefk)
    x_k = sum(c.to(I32) for c in leave_pref_k)
    if SK > cfg.XK:
        deepk = cross_k[cfg.XK:] & (sk_idx[cfg.XK:] < rs.n_k[None])
        ov = ov | _flag(_any_env(deepk), OV_HOPS)

    # ---- compact route lookups for link->lane entrants ------------------
    # per-intersection stable sort of this step's exits to the front of
    # the (XKe * LPI) candidate axis, then a global compaction to T2 rows
    # so the route-table gathers run on T2 indices per env
    XKe = len(leave_pref_k)
    exit_flags = torch.stack(leave_pref_k)                      # (XKe,LKp,B)
    TI = min(cfg.TI, XKe * LPI)
    NC = XKe * LPI
    ef3 = exit_flags.reshape(NC, G, B)
    ov = ov | _flag(_any_env(ef3.to(I32).sum(0) > TI), OV_REMOVE)
    src_iota = torch.arange(NC, dtype=I32, device=dev)[:, None, None] \
        .expand(NC, G, B)
    key = torch.where(ef3, src_iota, NC)
    endl_local = jnp_take(ln_llocal, net["lk_end_lane"].clamp(min=0)) \
        .reshape(1, LPI, G, 1)
    rowb3 = ((rs.k_route[:XKe].reshape(XKe, LPI, G, B).clamp(0, NR - 1)
              * RLEN + (rs.k_rpos[:XKe].reshape(XKe, LPI, G, B) + 1)
              .clamp(0, RLEN - 1)) * MAXLPR).reshape(NC, G, B)
    gidx3 = rowb3 + endl_local.clamp(0, MAXLPR - 1) \
        .expand(XKe, LPI, G, B).reshape(NC, G, B)
    skey, perm = torch.sort(key, dim=0, stable=True)
    s_gidx = torch.gather(gidx3, 0, perm)
    T2 = min(1024, TI * G)
    flat_key = torch.where(
        skey[:TI] < NC,
        (torch.arange(TI, dtype=I32, device=dev)[:, None] * G
         + torch.arange(G, dtype=I32, device=dev)[None, :])[..., None],
        TI * G).reshape(TI * G, B)
    k2, perm2 = torch.sort(flat_key, dim=0, stable=True)
    g2 = torch.gather(s_gidx[:TI].reshape(TI * G, B), 0, perm2)
    v2 = k2[:T2] < TI * G
    gi = g2[:T2].clamp(0, NR * RLEN * MAXLPR - 1).long()
    if T2 < TI * G:
        ov = ov | _flag(v2.all(0), OV_REMOVE)
    r_aux = net["route_aux"].reshape(-1)[gi]
    rvals = {"nxt": (rn.reshape(-1)[gi], -1),
             "nxt3": ((r_aux >> 1) - 2, -1),
             "last": (r_aux & 1, 0)}
    # scatter back to the (TI, G) stage-1 grid (dump row TI*G), then to the
    # (NC, G) candidate rows (dump row NC)
    tgt2 = torch.where(v2, k2[:T2].clamp(0, TI * G - 1), TI * G).long()
    c_valid = skey[:TI] < NC
    tgt1 = torch.where(c_valid, skey[:TI], NC).long()
    pays = {}
    for name, (vals, fill) in rvals.items():
        s_grid = torch.full((TI * G + 1, B), fill, dtype=I32, device=dev) \
            .scatter_(0, tgt2, vals.to(I32))[:-1].reshape(TI, G, B)
        pays[name] = torch.full((NC + 1, G, B), fill, dtype=I32, device=dev) \
            .scatter_(0, tgt1, s_grid)[:-1]
    pay_nxt = pays["nxt"].reshape(XKe, LKp, B)
    pay_nxt3 = pays["nxt3"].reshape(XKe, LKp, B)
    pay_last = (pays["last"] > 0).reshape(XKe, LKp, B)

    # ---- link ring: shift out + append entering lane fronts (K4) --------
    ex_cols = [exited_l[a].to(F32) if a < len(exited_l)
               else torch.zeros((LNp, B), device=dev) for a in range(AP)]
    ex_in = gather_rows(torch.stack(ex_cols), in_src, 0.0)     # (AP,ILG,B)
    ENT_CH = ["valid", "dis", "speed", "flow", "route", "rpos", "enter",
              "prih", "pril", "uid", "nxtl"]
    ent = torch.empty((AP, len(ENT_CH), LKp, B), device=dev)
    for a in range(AP):
        ex_a = (ex_in[a] > 0).reshape(IL, G, B) & h_occ[a]
        ok = ex_a & (h_nxt[a] >= 0)
        src = [mid["ap_dis"][a] - il_len, mid["ap_spd"][a],
               h["flow"][a].to(F32), h["route"][a].to(F32),
               h["rpos"][a].to(F32), h["enter"][a], h["prih"][a],
               h["pril"][a], h["uid"][a].to(F32), h["nxt3"][a].to(F32)]
        gather_rows(torch.stack([ok.to(F32)] + [
            torch.where(ok, x, 0.0) for x in src]).reshape(
                len(ENT_CH), IL * G, B),
            didx=cx.to_link_idx(lpi_hs[a]), fill=0.0, out=ent[a])
    ent_valid = ent[:, 0] > 0.5
    m_k = ent_valid.to(I32).sum(0, dtype=I32)
    new_n_k = rs.n_k - x_k + m_k
    ov = ov | _flag(_any_env(new_n_k > SK), OV_LINK_TABLE)
    new_n_k = torch.clamp_max(new_n_k, SK)
    ei = ENT_CH.index
    (new_k_dis, new_k_speed, new_k_flow, new_k_route, new_k_rpos,
     new_k_enter, new_k_pri, new_k_uid, new_k_nxtl, new_k_entll) = \
        ring_commit(
            [(nd_k, "f32", 0.0, ei("dis"), 0),
             (ns_k, "f32", 0.0, ei("speed"), 0),
             (rs.k_flow, "i32", 0.0, ei("flow"), 0),
             (rs.k_route, "i32", 0.0, ei("route"), 0),
             (rs.k_rpos, "i32", 0.0, ei("rpos"), 0),
             (rs.k_enter, "f32", 0.0, ei("enter"), 0),
             (rs.k_pri, "pri", 0.0, ei("prih"), ei("pril")),
             (rs.k_uid, "i32", -1.0, ei("uid"), 0),
             (rs.k_nxtl, "i32", -1.0, ei("nxtl"), 0),
             # entrants entered this step (engine.cpp:484-491)
             (rs.k_entll, "i32", float(INT_MAX), -1, 0)],
            x_k, rs.n_k - x_k, ent, valid_ch=0, sort_ch=-1, nsel=AP,
            XK=cfg.XK, envval=rs.step.to(F32))

    # ---- lane ring: shift out + append link leavers (pushBuffer order:
    #      distance desc, engine.cpp:477-494) (K1 candidates, K4 commit) --
    PCH = ["dis", "speed", "flow", "route", "rpos", "enter", "prih", "pril",
           "uid", "nxt", "nxt3", "last", "prev", "valid"]
    prih_k, pril_k = _hilo(rs.k_pri[:XKe])
    prev = (LNp + torch.arange(LKp, device=dev)).to(F32)[:, None] \
        .expand(LKp, B)
    A = cfg.KIN * XKe
    cands = torch.empty((A, len(PCH), OL * G, B), device=dev)
    for xs in range(XKe):
        payload = torch.stack([
            nd_k[xs] - net["lk_len"][:, None], ns_k[xs],
            rs.k_flow[xs].to(F32), rs.k_route[xs].to(F32),
            (rs.k_rpos[xs] + 1).to(F32), rs.k_enter[xs], prih_k[xs],
            pril_k[xs], rs.k_uid[xs].to(F32), pay_nxt[xs].to(F32),
            pay_nxt3[xs].to(F32), pay_last[xs].to(F32), prev,
            exit_flags[xs].to(F32)])
        for kin in range(cfg.KIN):
            gather_rows(payload, net["app_src_g"][kin], 0.0,
                        out=cands[kin * XKe + xs])
    m_ol = (cands[:, PCH.index("valid")] > 0.5).to(I32).sum(0, dtype=I32)
    SAE = min(cfg.SA, A)
    if A > cfg.SA:
        ov = ov | _flag(_any_env(m_ol > cfg.SA), OV_REMOVE)
    m_l = torch.zeros((OL, cfg.I, B), dtype=I32, device=dev)
    m_l[:, :G] = m_ol.reshape(OL, G, B)
    m_l = m_l.reshape(LNp, B)
    totdel = x_l
    new_n_l = rs.n_l - totdel + m_l
    ov = ov | _flag(_any_env(new_n_l > SL), OV_SLOTS)
    new_n_l = torch.clamp_max(new_n_l, SL)
    pi = PCH.index
    (new_l_dis, new_l_speed, new_l_flow, new_l_route, new_l_rpos,
     new_l_enter, new_l_pri, new_l_uid, new_l_nxt, new_l_nxt3, new_l_last,
     new_l_prev) = ring_commit(
        [(new_dis_l, "f32", 0.0, pi("dis"), 0),
         (new_spd_l, "f32", 0.0, pi("speed"), 0),
         (rs.l_flow, "i32", 0.0, pi("flow"), 0),
         (rs.l_route, "i32", 0.0, pi("route"), 0),
         (rs.l_rpos, "i32", 0.0, pi("rpos"), 0),
         (rs.l_enter, "f32", 0.0, pi("enter"), 0),
         (rs.l_pri, "pri", 0.0, pi("prih"), pi("pril")),
         (rs.l_uid, "i32", -1.0, pi("uid"), 0),
         (rs.l_nxt, "i32", -1.0, pi("nxt"), 0),
         (rs.l_nxt3, "i32", -1.0, pi("nxt3"), 0),
         (rs.l_last, "bool", 0.0, pi("last"), 0),
         (rs.l_prev, "i32", -1.0, pi("prev"), 0)],
        x_l, rs.n_l - totdel, cands, valid_ch=pi("valid"),
        sort_ch=pi("dis"), nsel=SAE, XK=cfg.XK, app_I=cfg.I, app_G=G)

    # ---- blocker graph commit (front-most failing vehicle per link) -----
    blk_new = torch.full((LPI, G, B), -1, dtype=I32, device=dev)
    for s in reversed(range(SK)):
        blk_new = torch.where(occ_k3[s] & k_fail_all[s], k_fffoe_all[s],
                              blk_new)
    for a in reversed(range(AP)):
        m = mid["ap_fail"][a] & ~mid["ap_red"][a]
        blk_new = torch.where((blk_new < 0) & m, mid["ap_ffo"][a], blk_new)

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

    dbg = {}
    if debug:
        dbg = dict(x_l=x_l, x_k=x_k, m_k=m_k, m_l=m_l,
                   new_dis_l=new_dis_l, new_spd_l=new_spd_l, ent=ent,
                   cands=cands)
    new_rs = rs.replace_fields(
        step=rs.step + 1,
        finished_cnt=rs.finished_cnt + n_rm,
        cum_travel=rs.cum_travel + t_rm,
        overflow=ov,
        n_l=new_n_l, n_k=new_n_k, blk=blk_new.reshape(LKp, B),
        phase=phase, phase_remain=remain,
        l_dis=new_l_dis, l_speed=new_l_speed, l_flow=new_l_flow,
        l_route=new_l_route, l_rpos=new_l_rpos, l_nxt=new_l_nxt,
        l_nxt3=new_l_nxt3, l_prev=new_l_prev, l_enter=new_l_enter,
        l_pri=new_l_pri, l_uid=new_l_uid, l_last=new_l_last,
        l_custom=torch.zeros((SL, LNp, B), device=dev),
        l_hascustom=torch.zeros((SL, LNp, B), dtype=torch.bool, device=dev),
        k_dis=new_k_dis, k_speed=new_k_speed, k_flow=new_k_flow,
        k_route=new_k_route, k_rpos=new_k_rpos, k_entll=new_k_entll,
        k_enter=new_k_enter, k_pri=new_k_pri, k_uid=new_k_uid,
        k_nxtl=new_k_nxtl,
        k_custom=torch.zeros((SK, LKp, B), device=dev),
        k_hascustom=torch.zeros((SK, LKp, B), dtype=torch.bool, device=dev))
    return new_rs, dbg


# ---------------------------------------------------------------------------
# entry points. The *_batched ones take trailing-batch state (leaves
# shape + (B,), batch_ring_state); the others take one env's state in the
# JAX package's shapes and run it as B = 1.
# ---------------------------------------------------------------------------

def _unsqueeze(x):
    return x[..., None]


def _squeeze(x):
    return x[..., 0]


def _map_mid(mid, fn):
    return {k: fn(v) for k, v in mid.items()}


def ring_step_p1_batched(net, cfg: RingConfig, rs_b: RingState, q):
    rs, mid, _ = _notify_phase(net, cfg, rs_b, q)
    return rs, mid


def ring_step_p2_batched(net, cfg: RingConfig, rs_b: RingState, mid_b):
    new_rs, _ = _commit_phase(net, cfg, rs_b, mid_b)
    return new_rs


def ring_step_batched(net, cfg: RingConfig, rs_b: RingState, q):
    rs, mid = ring_step_p1_batched(net, cfg, rs_b, q)
    return ring_step_p2_batched(net, cfg, rs, mid)


def ring_step_p1(net, cfg: RingConfig, rs: RingState, q):
    rs_b, mid_b = ring_step_p1_batched(net, cfg, rs.map(_unsqueeze), q)
    return rs_b.map(_squeeze), _map_mid(mid_b, _squeeze)


def ring_step_p2(net, cfg: RingConfig, rs: RingState, mid):
    return ring_step_p2_batched(net, cfg, rs.map(_unsqueeze),
                                _map_mid(mid, _unsqueeze)).map(_squeeze)


def ring_step(net, cfg: RingConfig, rs: RingState, q, debug: bool = False):
    """One Engine::nextStep on one env. With debug=True also returns the
    intermediates of both phases (tests only)."""
    rs1, mid, dbg1 = _notify_phase(net, cfg, rs.map(_unsqueeze), q, debug)
    new_rs, dbg2 = _commit_phase(net, cfg, rs1, mid, debug)
    new_rs = new_rs.map(_squeeze)
    if debug:
        dbg1.update(dbg2)
        dbg1["mid"] = mid
        return new_rs, dbg1
    return new_rs


def ring_step_split(net, cfg: RingConfig, rs: RingState, q):
    """ring_step as its two phases; the same arithmetic by construction."""
    rs, mid = ring_step_p1(net, cfg, rs, q)
    return ring_step_p2(net, cfg, rs, mid)
