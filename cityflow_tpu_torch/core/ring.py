"""Gen-2 ring-layout step in PyTorch: vehicle attributes stored per
drivable, the trailing axis of every state leaf is the env batch B.

A port of the JAX package's core/ring.py: uniform or non-uniform vehicle
templates, with or without lane change (core/ring_lc.py), with or without
the lane-history window of the DURATION router. Each phase mirrors the
reference (engine.cpp / vehicle.cpp / roadnet.cpp) through the same
formulas in the same float32 operation order as the JAX version.

Non-uniform templates (cfg.uniform False) ride as a per-slot template
index (l_tpl / k_tpl). The parameters of a slot come from its template
through the _PP provider (T1, kernels/tpl_params.py) in the plain regions,
and inside K2, K3, L1 and L2 in their template modes. The scalar
cfg.params are NaN there (ring_sim.build_sim), so a use site that is
missed yields NaN instead of simulating template 0.

Where the JAX version applies a one-hot operator with an einsum, this one
gathers through the index tables of compiler/ring_net.index_tables (K1,
kernels/gather_rows.py). Cross::canPass runs in K2 (kernels/cross_caps.py,
each cross's foe read in place from R1's fields through foe_src),
the car-following min-rule in K3 (kernels/car_follow.py), both ring
commits in K4 (kernels/ring_commit.py), the lane-history window in O1
(kernels/lane_stats.py), spawn and admission in R3
(kernels/ring_admit.py), the notify winners and the blocker-cycle flag in
R1 (kernels/notify_winners.py), the crossings, removals, pair flags,
blockers and lights in R2 (kernels/ring_exits.py) and the transfers' route
rows in R4 (kernels/route_rows.py), the lane fronts' leaders from the
link rings' tails in R5 (kernels/front_leaders.py: the approach rows'
inputs, and lc_front_ctx), the lane-change gap refresh in R6
(kernels/gap_refresh.py, core/ring_lc.refresh_gaps) and the channel packs
between the kernels in R7 (kernels/ring_pack.py: the forward exchange,
the link entrants, the lane candidates, the approach rows' to_link
pack); K3's ring-leader mode reads each slot's leader from the ring in
place. On a CPU tensor each of those takes its plain PyTorch version.

The batched entries write their input state in place (R3's admission, the
history rows), as the JAX package's batched entries donate theirs: their
caller does not reuse the state it passed in. p2 also writes p1's
mid["new_dis_l"] (R2's clamp of the invalid vehicles). The single-env
entries copy what is written first.

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

from cityflow_tpu_torch.core import ring_lc
from cityflow_tpu_torch.compiler.net import (
    P_LEN, P_MAXPOSACC, P_MAXNEGACC, P_USUALPOSACC, P_USUALNEGACC,
    P_MINGAP, P_MAXSPEED, P_HEADWAY, P_YIELD, P_TURNSPEED)
from cityflow_tpu_torch.core.numerics import xla_f32_to_i32
from cityflow_tpu_torch.core.state import (
    INT_MAX, OV_LINK_TABLE, OV_REMOVE, OV_SLOTS)
from cityflow_tpu_torch.core.step import leader_scan_bound
from cityflow_tpu_torch.kernels._ring_idx import (
    hilo as _hilo, sel_slot as _sel_slot)
from cityflow_tpu_torch.kernels.car_follow import RingLeaders, car_follow
from cityflow_tpu_torch.kernels.cross_caps import cross_caps
from cityflow_tpu_torch.kernels.front_leaders import (
    front_leaders, front_leaders_lc)
from cityflow_tpu_torch.kernels.gather_rows import gather_rows
from cityflow_tpu_torch.kernels.lane_stats import lane_history
from cityflow_tpu_torch.kernels.notify_winners import notify_winners
from cityflow_tpu_torch.kernels.ring_admit import ADMIT_FIELDS, ring_admit
from cityflow_tpu_torch.kernels.ring_commit import ring_commit
from cityflow_tpu_torch.kernels.ring_exits import (
    ring_exits, ring_exits_finish, ring_exits_pairs)
from cityflow_tpu_torch.kernels.ring_pack import (
    candidate_channels, entrant_channels, pack_approach, pack_candidates,
    pack_entrants, pack_forward)
from cityflow_tpu_torch.kernels.route_rows import route_rows
from cityflow_tpu_torch.kernels.tpl_params import tpl_params

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
    uniform: bool = True      # all templates identical: params are scalars
    TP: int = 1               # distinct templates (tpl_params table rows)
    rl_traffic_light: bool = False
    k_phase: int = 8
    k_cyc: int = 4
    SKC: int = 99             # link ring slots that evaluate Cross::canPass
    MAXLPR: int = 1           # route-table lanes-per-road width
    lane_change: bool = False # the signal/shadow protocol (core/ring_lc.py)
    LCI: int = 2              # shadow inserts per lane per step (flagged)
    LCD: int = 2              # mid-ring finish removals per lane per step
    track_history: bool = False  # Lane::updateHistory rolling window
                              # (roadnet.cpp:900-915), RouterType::DURATION
    history_len: int = 240    # HISTORY_LEN (roadnet.h:306)


STATE_FIELDS = ("step", "finished_cnt", "cum_travel", "overflow",
                "n_l", "n_k", "el_cursor", "phase", "phase_remain", "blk",
                "l_dis", "l_speed", "l_flow", "l_route", "l_rpos",
                "l_nxt", "l_nxt3", "l_prev", "l_enter", "l_pri",
                "l_uid", "l_last", "l_custom", "l_hascustom",
                "k_dis", "k_speed", "k_flow", "k_route", "k_rpos",
                "k_entll", "k_enter", "k_pri", "k_uid", "k_nxtl",
                "k_custom", "k_hascustom")
# lane-change leaves: None (not allocated) when cfg.lane_change is off
LC_FIELDS = ("l_off", "l_sh", "l_chg", "l_dir", "l_gap", "l_yv", "l_rnrow",
             "l_auxrow", "k_gap")
# mid entries of the port's own under lane change: L4's match and found
# mask, kept from p1 for the commit's pair rounds (JAX's p2 searches
# again); p2 requires them
LC_MATCH_KEYS = ("lc_match", "lc_found")
# template-index leaves: None when cfg.uniform
TPL_FIELDS = ("l_tpl", "k_tpl")
# lane-history leaves: None when cfg.track_history is off
HIST_FIELDS = ("h_ring_num", "h_ring_ssum", "h_num", "h_ssum", "h_t")
OPTIONAL_FIELDS = LC_FIELDS + TPL_FIELDS + HIST_FIELDS
STATE_FIELDS = STATE_FIELDS + OPTIONAL_FIELDS
FLOAT_FIELDS = frozenset({"cum_travel", "phase_remain", "l_dis", "l_speed",
                          "l_enter", "l_custom", "k_dis", "k_speed",
                          "k_enter", "k_custom", "l_off", "l_gap", "l_yv",
                          "k_gap", "h_ring_num", "h_ring_ssum", "h_num",
                          "h_ssum"})
BOOL_FIELDS = frozenset({"l_last", "l_hascustom", "k_hascustom", "l_sh",
                         "l_chg"})


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
    # lane-change channels (None when cfg.lane_change is off)
    l_off: Any = None         # signed lateral offset (changing reals)
    l_sh: Any = None          # shadow flag
    l_chg: Any = None         # changing flag (real side)
    l_dir: Any = None         # -1/0/+1 change direction (both sides)
    l_gap: Any = None         # Vehicle::controllerInfo.gap incl. staleness
    l_yv: Any = None          # per-step yieldSpeed (100 = no-op)
    l_rnrow: Any = None       # (MAXLPR, SL, LNp) route-next row bundle
    l_auxrow: Any = None      # (MAXLPR, SL, LNp) two-hop aux row bundle
    k_gap: Any = None         # link-side gap channel (staleness carrier)
    # template channels (None when cfg.uniform)
    l_tpl: Any = None         # (SL, LNp) i32 template index
    k_tpl: Any = None         # (SK, LKp) i32 template index
    # lane-history channels (None when cfg.track_history is off), speed
    # SUMS like the JAX package's
    h_ring_num: Any = None    # (history_len + 1, LNp) per-step lane counts
    h_ring_ssum: Any = None   # (history_len + 1, LNp) per-step speed sums
    h_num: Any = None         # (LNp,) window count sum
    h_ssum: Any = None        # (LNp,) window speed sum
    h_t: Any = None           # i32 updateHistory calls so far

    def replace_fields(self, **kw):
        return dataclasses.replace(self, **kw)

    def leaves(self):
        """The allocated leaves (lane-change and history ones only when
        present)."""
        return {k: v for k in STATE_FIELDS
                if (v := getattr(self, k)) is not None}

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
    lc = {}
    if cfg.lane_change:
        bl = lambda: torch.zeros((SL, LNp), dtype=torch.bool, **kw)
        lc = dict(
            l_off=zl(), l_sh=bl(), l_chg=bl(), l_dir=il_(0),
            l_gap=zl(),                      # Vehicle ctor: gap = 0
            l_yv=torch.full((SL, LNp), 100.0, dtype=F32, **kw),
            l_rnrow=torch.full((cfg.MAXLPR, SL, LNp), -1, dtype=I32, **kw),
            l_auxrow=torch.full((cfg.MAXLPR, SL, LNp), -1, dtype=I32, **kw),
            k_gap=zk())
    if not cfg.uniform:
        lc.update(l_tpl=il_(0), k_tpl=ik(0))
    if cfg.track_history:
        HL1 = cfg.history_len + 1
        lc.update(h_ring_num=torch.zeros((HL1, LNp), dtype=F32, **kw),
                  h_ring_ssum=torch.zeros((HL1, LNp), dtype=F32, **kw),
                  h_num=torch.zeros(LNp, dtype=F32, **kw),
                  h_ssum=torch.zeros(LNp, dtype=F32, **kw),
                  h_t=scalar(0, I32))
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
        k_hascustom=torch.zeros((SK, LKp), dtype=torch.bool, **kw), **lc)


def batch_ring_state(st: RingState, B: int) -> RingState:
    """Replicate a single-env RingState into the trailing-batch layout
    consumed by ring_step_*_batched (leaves become shape + (B,)). Every
    leaf is a new tensor, B = 1 included: the batched entries write their
    state in place (admission, the history rows), and `st` stays as it
    was."""
    return st.map(lambda x: x[..., None].repeat(*([1] * x.dim()), B))


def _update_history(cfg: RingConfig, rs: RingState) -> RingState:
    """Lane::updateHistory (roadnet.cpp:900-915; JAX ring.py:210-236) on
    trailing-batch state, through O1's history mode: the lane count is the
    slot occupancy n_l (shadows included), the speed sum runs over the
    occupied slots, and ring row h_t % (history_len + 1) of each env takes
    both. The subtraction removes exactly the stored entry, so the window
    sums carry no drift. The ring rows are written in place, as the JAX
    batched entries donate their state: a caller of the batched entries
    does not reuse the state it passed in."""
    h_num, h_ssum = lane_history(rs.l_speed, rs.n_l, rs.h_ring_num,
                                 rs.h_ring_ssum, rs.h_num, rs.h_ssum, rs.h_t)
    return rs.replace_fields(h_num=h_num, h_ssum=h_ssum, h_t=rs.h_t + 1)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

# region marks read by tools/profile_ring.py --regions: None (off), or a
# list that each mark appends (name, a recorded CUDA event) to, so the
# device time up to the next mark books to the region the mark opens
SPANS = None


def _span(name):
    if SPANS is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        SPANS.append((name, ev))


def _any_env(x):
    """Reduce every axis but the trailing env axis with any()."""
    return x.reshape(-1, x.shape[-1]).any(dim=0)


def _flag(cond, bit):
    return cond.to(I32) * bit


class _PP:
    """Parameter provider (JAX ring.py:270-297). Uniform: cfg.params[i] as
    a Python float, so the uniform step is the one without templates.
    Non-uniform: the `cols` of each element's template (T1, one launch
    for all of them), (*tpl.shape) float32 per column; build one _PP per
    role (self, leader) from the matching template index."""

    def __init__(self, cfg, net, tpl=None, cols=()):
        self.cfg = cfg
        self.cols = tuple(cols)
        self.P = None if cfg.uniform else tpl_params(
            tpl.contiguous(), net["tpl_params"], self.cols)

    def __getitem__(self, i):
        if self.cfg.uniform:
            return self.cfg.params[i]
        return self.P[self.cols.index(i)]


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


def _front_views(cfg, inl):
    """Decode the in-lane view of the forward exchange (JAX ap_ch): the
    float channels p1 reads, the next link and the template index."""
    AP = cfg.AP
    ch = lambda c: inl[c * AP:(c + 1) * AP]
    v = dict(dis=ch(0), speed=ch(1), nxt=xla_f32_to_i32(ch(2)),
             prih=ch(7), pril=ch(8), custom=ch(11), hascustom=ch(12) > 0,
             occ_raw=ch(13) > 0)
    if cfg.lane_change:          # yield speed
        v["yv"] = ch(15)
    if not cfg.uniform:          # template index (channel 16 / 14)
        v["tpl"] = xla_f32_to_i32(ch(16 if cfg.lane_change else 14))
    NFC = (inl.shape[0] - 2) // AP
    v["il_len"] = inl[NFC * AP]
    v["il_maxspd"] = inl[NFC * AP + 1]
    return v


def lc_front_ctx(net, cfg: RingConfig, rs: RingState, cx=None):
    """Link-domain context of the lane-change phase (JAX ring.py:344-448),
    on the pre-admission state, from R5's lane-change mode: per-lane
    out-link ring tails (olt_*, the lanechange.cpp:33-47 fallback
    candidates), the leader-scan overlap-rule winner of each lane front
    (best_*), the front's next-link length and end-lane tail (nlen / etd /
    ete), and per link the end-lane tail (k_etd / k_ete) for the k_gap
    refresh. Non-uniform templates: the tails' lengths ride along (etl /
    olt_len / k_etl) and each candidate subtracts its own length.

    `cx` is deprecated and not read: it stays only so that callers written
    against the JAX signature (which passes the per-call context) keep
    working, and goes once none does."""
    return front_leaders_lc(cfg, net, rs)


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
    G, LPI, IL, AP = cfg.G, cfg.LPI, cfg.IL, cfg.AP
    ov = rs.overflow
    # the uniform path's scalar parameters; NaN with non-uniform templates,
    # where every use below is guarded by `uni` or replaced by a _PP
    prm = cfg.params
    p_len, p_una, p_maxspd = prm[P_LEN], prm[P_USUALNEGACC], prm[P_MAXSPEED]
    approach = leader_scan_bound(p_maxspd, p_una, cfg.interval)
    lc = cfg.lane_change
    uni = cfg.uniform
    tpp = None if uni else net["tpl_params"]
    if lc:
        # stale-gap refresh on the pre-admission rings: makeSignal reads
        # controllerInfo.gap as the end of the previous step's
        # updateLeaderAndGap left it (engine.cpp:581)
        _span("lc_front_ctx")
        fx = lc_front_ctx(net, cfg, rs)
        _span("refresh_gaps")
        rs = ring_lc.refresh_gaps(net, cfg, rs, fx)

    # =====================================================================
    # 1. spawn + admission (Flow::nextStep + Engine::handleWaiting,
    #    engine.cpp:502-516): R3, in place on rs's lane leaves
    # =====================================================================
    _span("admit")
    ov = ov | ring_admit(cfg, net, rs, q, *(
        (fx["best_ex"], fx["best_val"]) if lc else ()))

    # ---- lane change: signals, arbitration, shadow insertion
    # (engine.cpp:571-575); the pre-admission link context stays valid,
    # since admissions do not touch the link rings
    if lc:
        _span("lc_phase")
        rs, lc_ov = ring_lc.lc_phase(net, cfg, rs, fx)
        ov = ov | _flag((lc_ov & 1) > 0, OV_REMOVE) \
            | _flag((lc_ov & 2) > 0, OV_SLOTS)
        if cfg.track_history:
            # the step's first updateHistory: the lane-change pipeline runs
            # updateLeaderAndGap after the shadow inserts (engine.cpp:
            # 571-581), so the counts see fresh shadows and the speeds are
            # last step's
            rs = _update_history(cfg, rs)

    # =====================================================================
    # 2. views
    # =====================================================================
    _span("tails")
    sk_idx = torch.arange(SK, device=dev)[:, None, None]
    occ_k = sk_idx < rs.n_k[None]

    # lane tail bundle (rear vehicle; link end-specials + canEnter)
    tl_dis = _sel_slot(rs.l_dis, rs.n_l)
    tl_prev = _sel_slot(rs.l_prev, rs.n_l)
    tl_speed = _sel_slot(rs.l_speed, rs.n_l)
    tl_prih, tl_pril = _hilo(_sel_slot(rs.l_pri, rs.n_l))
    tl_exists = rs.n_l > 0
    tl_tpl = None if uni else _sel_slot(rs.l_tpl, rs.n_l)

    # forward exchange: lane-front bundles -> (AP, IL, G) in-lane view (R7)
    _span("fwd_pack")
    inl_flat = pack_forward(cfg, net, rs)                  # (C, IL*G, B)
    inl = inl_flat.reshape(-1, IL, G, B)
    src_ok = (net["in_src"].reshape(-1) >= 0).reshape(IL, G)[None, :, :,
                                                              None]
    h = _front_views(cfg, inl)
    h_dis, h_speed, h_nxt = h["dis"], h["speed"], h["nxt"]
    h_prih, h_pril = h["prih"], h["pril"]
    h_occ = h["occ_raw"] & src_ok
    il_len, il_maxspd = h["il_len"], h["il_maxspd"]
    h_tpl = h.get("tpl")

    # =====================================================================
    # 3. link domain
    # =====================================================================
    _span("et_st")
    ph_row = net["g_phase_offset"][:, None] + rs.phase[:G].clamp(min=0)
    pra = net["phase_rl_avail"]
    avail_rows = pra[ph_row.clamp(0, pra.shape[0] - 1).long()]  # (G,B,MAXRL)
    MAXRL = pra.shape[1]
    avail_lk = gather_rows(
        avail_rows.permute(2, 0, 1).reshape(1, MAXRL * G, B).contiguous(),
        net["rl_src"], 0.0).reshape(LPI, G, B) > 0.5

    lk_turn = net["lk_turn"].reshape(LPI, G, 1)

    # end-lane tail bundle per link (E_end after the (OL, I) lane view)
    et_in = [tl_dis, tl_prev.to(F32), tl_speed, tl_prih, tl_pril,
             tl_exists.to(F32)] + ([] if uni else [tl_tpl.to(F32)])
    et = gather_rows(torch.stack(et_in), net["end_src"], 0.0)
    et4 = et.reshape(len(et_in), LPI, G, B)
    end_tail_dis = et4[0]
    end_tail_speed = et4[2]
    end_tail_exists = et4[5] > 0.5
    if not uni:
        end_tail_tpl = xla_f32_to_i32(et4[6])
        end_tail_len = _PP(cfg, net, end_tail_tpl, (P_LEN,))[P_LEN]

    # start-lane head bundle per link (E_start)
    st_in = [h_dis[0], h_nxt[0].to(F32), h_speed[0], h_prih[0], h_pril[0],
             h_occ[0].to(F32), il_len] + ([] if uni else [h_tpl[0].to(F32)])
    st = gather_rows(torch.stack(st_in).reshape(len(st_in), IL * G, B),
                     net["start_src"], 0.0)

    kdis3 = rs.k_dis.reshape(SK, LPI, G, B)
    kspd3 = rs.k_speed.reshape(SK, LPI, G, B)
    kprih, kpril = _hilo(rs.k_pri.reshape(SK, LPI, G, B))
    if not uni:
        k_tpl3 = rs.k_tpl.reshape(SK, LPI, G, B)
        k_len3 = _PP(cfg, net, k_tpl3, (P_LEN,))[P_LEN]  # own lengths

    # ---- notify winners (Engine::threadNotifyCross, engine.cpp:317-372)
    # and the blocker-cycle flag (R1); K2 reads each cross's foe in place
    # through foe_src (the foe exchange)
    _span("notify")
    fields = notify_winners(cfg, net, rs.k_dis, rs.k_speed, rs.k_entll,
                            rs.k_pri, rs.n_k, rs.blk, et, st, avail_lk,
                            k_tpl=None if uni else rs.k_tpl)

    # ---- link ring rows: Cross::canPass (K2) + car following (K3) --------
    _span("link_leaders")
    # Lane::canEnter of the link's end lane (roadnet.cpp:438-445): tail dis
    # > tail len + the subject's len, or the tail moving (with templates,
    # the approach rows' own comes from R7's approach mode)
    if uni:
        can_enter_k = (~end_tail_exists | (end_tail_dis > p_len + p_len)
                       | (end_tail_speed >= 2))
        tpl_k = {}
        ce_k = can_enter_k
    else:
        tpl_k = dict(tpl=k_tpl3, table=tpp)
        ce_k = (~end_tail_exists | (end_tail_dis > end_tail_len + k_len3)
                | (end_tail_speed >= 2))

    _span("link_rows")
    R = min(cfg.SKC, SK)
    af_r, fd_r, ffo_r = cross_caps(
        rs.k_dis[:R], rs.k_speed[:R],
        torch.clamp_max(rs.k_entll[:R], 1 << 25).to(F32),
        kprih[:R].reshape(R, LKp, B), kpril[:R].reshape(R, LKp, B),
        occ_k[:R], fields, net["foe_src"], cx.cc_tabs, cx.prm_cc,
        **({} if uni else dict(tpl=rs.k_tpl[:R], table=tpp)))
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
    # the leader of slot s is slot s - 1 of the ring, slot 0's the end-lane
    # tail (K3's ring-leader mode reads both in place)
    ns_k3, dd_k, nd_k3 = car_follow(
        3, cx.prm_cf, (SK, LPI, G, B),
        speed=kspd3, dls=kdis3, isr_lane_left=0.0, any_fail=k_fail_all,
        ff_d=k_ffd_all.reshape(SK, LPI, G, B), app=False, avail=avail_lk,
        can_enter=ce_k, turn=lk_turn, isr_rel=True,
        custom=rs.k_custom.reshape(SK, LPI, G, B),
        has_custom=rs.k_hascustom.reshape(SK, LPI, G, B),
        drv_maxspd=10000.0,          # LaneLink maxSpeed, roadnet.h:456
        invalid=False, lane_left=0.0,
        ring=RingLeaders("link", rs.k_dis, rs.k_speed, rs.n_k, rs.k_tpl,
                         net["lk_len"], p_len, s0=et), **tpl_k)

    # ---- approach rows: lane fronts computed per link then sent back ----
    # each lane-front slot routed to its next link (R7's approach mode),
    # one batched cross_caps / isr pass over all AP rows, then back
    _span("approach_rows")
    mine_ilgs = [h_occ[a] & (h_nxt[a] >= 0) for a in range(AP)]
    ap = pack_approach(cfg, net, inl_flat, st, None if uni else et)
    ap4 = lambda x: x.reshape(AP, LPI, G, B)
    mine_lk = ap4(ap["mine"])
    if uni:
        approach_ap, ce_ap, tpl_ap_kw, cc_ap_kw = approach, can_enter_k, {}, {}
    else:
        approach_ap, ce_ap = ap4(ap["approach"]), ap4(ap["ce"])
        tpl_ap_kw = dict(tpl=ap4(ap["tpl"]), table=tpp)
        cc_ap_kw = dict(tpl=ap["tpl"], table=tpp)
    af_ap, fd_ap, ffo_ap = cross_caps(
        ap["dls"], ap["speed"], ENT_BIG, ap["prih"], ap["pril"], ap["mine"],
        fields, net["foe_src"], cx.cc_tabs, cx.prm_cc, **cc_ap_kw)
    af_ap = af_ap.reshape(AP, LPI, G, B)
    fd_ap = fd_ap.reshape(AP, LPI, G, B)
    ffo_ap = ffo_ap.reshape(AP, LPI, G, B)
    lane_left_lk = ap4(ap["lane_left"])
    v_isr_ap, red_ap = car_follow(
        1, cx.prm_cf, (AP, LPI, G, B), speed=ap4(ap["speed"]),
        dls=ap4(ap["dls"]), isr_lane_left=lane_left_lk, any_fail=af_ap,
        ff_d=fd_ap, app=True, avail=avail_lk, can_enter=ce_ap, turn=lk_turn,
        **tpl_ap_kw)
    isr_rel_ap = mine_lk & (lane_left_lk <= approach_ap)

    # the fronts' leaders: the out-link ring tails (Lane::laneLinks order,
    # strict-min on dis - len, vehicle.cpp:170-180), else the next link's
    # end-lane tail; slot a > 0 follows slot a - 1; v_isr / isr_rel read
    # back from the link domain (R5)
    _span("approach_fronts")
    fl = front_leaders(cfg, net, rs, inl_flat, et, v_isr_ap, isr_rel_ap)
    ap_kw = dict(speed=h_speed, gap=fl["gap"], lead_spd=fl["lead_spd"],
                 has_lead=fl["has_lead"], v_isr=fl["v_isr"],
                 isr_rel=fl["isr_rel"], custom=h["custom"],
                 has_custom=h["hascustom"], drv_maxspd=il_maxspd,
                 invalid=False, lane_left=fl["lane_left"])
    if not uni:
        ap_kw.update(tpl=h_tpl.contiguous(), lead_tpl=fl["lead_tpl"],
                     table=tpp)
    _span("approach_k3")
    if lc:
        # raw (pre-kinematics) speed: the real/shadow lockstep min runs in
        # the lane domain before the negative-speed split
        ap_spd = car_follow(2, cx.prm_cf, (AP, IL, G, B), raw=True,
                            v_yield=h["yv"], **ap_kw)
        ap_dis, ap_dd = h_dis, None
    else:
        ap_spd, ap_dd = car_follow(2, cx.prm_cf, (AP, IL, G, B), **ap_kw)
        ap_dis = h_dis + ap_dd

    # --- lane-domain dynamics for all slots: K3 reads each slot's leader
    # in slot s - 1 and takes the relevant approach rows' results at the
    # fronts ------------------------------------------------------------
    _span("lane_rows")
    ring_l = RingLeaders(
        "lane", rs.l_dis, rs.l_speed, rs.n_l, rs.l_tpl, net["ln_len"], p_len,
        nxt=rs.l_nxt, last=rs.l_last, in_inv=net["in_inv"], ap_v=ap_spd,
        ap_d=None if lc else ap_dis, ap_rel=torch.stack(mine_ilgs))
    lane_kw = dict(
        speed=rs.l_speed, v_isr=0.0, isr_rel=False, custom=rs.l_custom,
        has_custom=rs.l_hascustom, drv_maxspd=net["ln_maxspd"][:, None],
        ring=ring_l)
    if not uni:
        lane_kw.update(tpl=rs.l_tpl, table=tpp)
    if lc:
        vraw_l = car_follow(2, cx.prm_cf, (SL, LNp, B), raw=True,
                            v_yield=rs.l_yv, **lane_kw)
        # real + shadow lockstep: the min of both raw next speeds
        # (engine.cpp:195-210), partners through L4; the match is kept for
        # the commit's pair rounds (nothing writes l_uid, l_sh, l_dir,
        # l_chg or n_l in between)
        (pv,), pf, lc_match = ring_lc.partner_fetch(net, rs, [vraw_l],
                                                    with_match=True)
        vmin = torch.where(pf, torch.minimum(vraw_l, pv), vraw_l)
        neg = vmin < 0
        mneg_l = F(P_MAXNEGACC) if uni else \
            _PP(cfg, net, rs.l_tpl, (P_MAXNEGACC,))[P_MAXNEGACC]
        delta_l = torch.where(
            neg, 0.5 * rs.l_speed * rs.l_speed / mneg_l,
            (rs.l_speed + vmin) * dt / 2)
        new_spd_l = torch.where(neg, 0.0, vmin)
        new_dis_l = rs.l_dis + delta_l
    else:
        new_spd_l, delta_l, new_dis_l = car_follow(
            2, cx.prm_cf, (SL, LNp, B), **lane_kw)

    _span("p1_end")
    mid = dict(
        inl=inl, nd_k3=nd_k3, ns_k3=ns_k3,
        new_dis_l=new_dis_l, new_spd_l=new_spd_l,
        k_fail=k_fail_all, k_fffoe=k_fffoe_all,
        ap_spd=ap_spd, ap_dis=ap_dis,
        ap_fail=af_ap & mine_lk, ap_ffo=ffo_ap, ap_red=red_ap & mine_lk,
        ov=ov)
    if lc:
        mid.update(lc_match=lc_match, lc_found=pf)
    if debug:
        dbg.update(k2_link=(af_r, fd_r, ffo_r), k2_ap=(af_ap, fd_ap, ffo_ap),
                   k3_link=(ns_k3, dd_k), k3_ap_isr=(v_isr_ap, red_ap),
                   k3_ap=(ap_spd, ap_dd), k3_lane=(new_spd_l, delta_l))
    return rs, mid, dbg


def _lc_pairs(net, cfg, rs, ex, mid):
    """The commit's real / shadow pair bookkeeping (JAX ring.py:1484-1529):
    two partner-exchange rounds (L4, gathering at p1's match) around R2's
    pair stages decide shadow aborts, finished changes, promotions and
    unlinks, and the lateral offset integrates (engine.cpp:223-243). The
    aborted shadows join ex's n_rm / t_rm. `mid` holds p1's match
    (LC_MATCH_KEYS)."""
    leave = ex["leave"]
    match, pf = mid["lc_match"], mid["lc_found"]
    # round 1: who transfers into a link / dies at its route end this step
    pA, pB = ring_lc.partner_gather(net, match, [ex["chanA"], ex["chanB"]])
    p1 = ring_exits_pairs(cfg, net, rs, mid["new_spd_l"], leave, pA, pf)
    # round 2: abort / finish flags across the pair
    pAb, pFin = ring_lc.partner_gather(
        net, match, [p1["abort_sh"], p1["finish_pre"]])
    p2 = ring_exits_finish(cfg, net, rs, leave, p1["abort_sh"],
                           p1["finish_pre"], pAb, pFin, pf, pB,
                           ex["n_rm"], ex["t_rm"])
    return dict(p2, leave_full=leave, new_off=p1["new_off"])


def _commit_phase(net, cfg: RingConfig, rs: RingState, mid,
                  debug: bool = False):
    """Transfers, removals, ring commits, blockers and lights (the second
    half of Engine::nextStep) on trailing-batch state."""
    dev = rs.n_l.device
    B = rs.n_l.shape[-1]
    SL, SK, LNp, LKp = cfg.SL, cfg.SK, cfg.LNp, cfg.LKp
    G, IL, OL, AP = cfg.G, cfg.IL, cfg.OL, cfg.AP
    ov = mid["ov"]
    MAXLPR = net["route_next"].shape[2]
    ns_k3 = mid["ns_k3"]
    new_spd_l = mid["new_spd_l"]

    # =====================================================================
    # 4. transfers / removals / commit
    # =====================================================================
    # crossings, leave prefixes, removals, blockers and lights (R2)
    _span("exits")
    ex = ring_exits(cfg, net, rs, mid)
    ov = ov | ex["ov"]
    new_dis_l, x_l, x_k = ex["dis_l"], ex["x_l"], ex["x_k"]
    lc = cfg.lane_change
    if lc:
        lcc = _lc_pairs(net, cfg, rs, ex, mid)
        n_rm, t_rm = lcc["n_rm"], lcc["t_rm"]
    else:
        n_rm, t_rm = ex["n_rm"], ex["t_rm"]
    nd_k = mid["nd_k3"].reshape(SK, LKp, B)
    ns_k = ns_k3.reshape(SK, LKp, B)

    # ---- route rows of this step's link -> lane entrants (R4) -----------
    _span("route_rows")
    exit_flags = ex["leave_k"]                                  # (XKe,LKp,B)
    XKe = exit_flags.shape[0]
    pays, ov_r = route_rows(cfg, net, exit_flags, rs.k_route, rs.k_rpos)
    ov = ov | ov_r

    # ---- link ring: shift out + append entering lane fronts (R7's
    # entrant pack, K4) ----------------------------------------------------
    _span("ent_pack")
    uni = cfg.uniform
    ENT_CH = entrant_channels(cfg)
    # under lane change the lockstep / yield min runs in the lane domain, so
    # the final front speeds and distances live there
    ent = pack_entrants(
        cfg, net, mid["inl"].reshape(-1, IL * G, B), ex["exited"],
        **(dict(new_dis_l=new_dis_l, new_spd_l=new_spd_l) if lc else
           dict(ap_dis=mid["ap_dis"], ap_spd=mid["ap_spd"])))
    _span("link_commit")
    ent_valid = ent[:, 0] > 0.5
    m_k = ent_valid.to(I32).sum(0, dtype=I32)
    new_n_k = rs.n_k - x_k + m_k
    ov = ov | _flag(_any_env(new_n_k > SK), OV_LINK_TABLE)
    new_n_k = torch.clamp_max(new_n_k, SK)
    ei = ENT_CH.index
    kouts = ring_commit(
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
         (rs.k_entll, "i32", float(INT_MAX), -1, 0)]
        + ([(rs.k_gap, "f32", 0.0, ei("gap"), 0)] if lc else [])
        + ([] if uni else [(rs.k_tpl, "i32", 0.0, ei("tpl"), 0)]),
        x_k, rs.n_k - x_k, ent, valid_ch=0, sort_ch=-1, nsel=AP,
        XK=cfg.XK, envval=rs.step.to(F32))
    (new_k_dis, new_k_speed, new_k_flow, new_k_route, new_k_rpos,
     new_k_enter, new_k_pri, new_k_uid, new_k_nxtl, new_k_entll) = kouts[:10]

    # ---- lane ring: shift out + append link leavers (pushBuffer order:
    #      distance desc, engine.cpp:477-494) (R7's candidate pack, K4) ----
    _span("cand_pack")
    PCH = candidate_channels(cfg, MAXLPR)
    A = cfg.KIN * XKe
    cands = pack_candidates(cfg, net, rs, nd_k, ns_k, pays, exit_flags)
    _span("lane_commit")
    m_ol = (cands[:, PCH.index("valid")] > 0.5).to(I32).sum(0, dtype=I32)
    SAE = min(cfg.SA, A)
    if A > cfg.SA:
        ov = ov | _flag(_any_env(m_ol > cfg.SA), OV_REMOVE)
    m_l = torch.zeros((OL, cfg.I, B), dtype=I32, device=dev)
    m_l[:, :G] = m_ol.reshape(OL, G, B)
    m_l = m_l.reshape(LNp, B)
    if lc:
        # mid-ring deletions (finishing reals, aborted shadows) and the
        # prefix leavers make one rank-preserving delete, at most
        # XD = XK + LCD slots per lane
        del_full = lcc["leave_full"] | lcc["die_mid"]
        totdel = x_l + lcc["die_mid"].to(I32).sum(0, dtype=I32)
        XD = min(cfg.XK + cfg.LCD, SL)
        ov = ov | _flag(_any_env(totdel > XD), OV_REMOVE)
    else:
        totdel = x_l
    new_n_l = rs.n_l - totdel + m_l
    ov = ov | _flag(_any_env(new_n_l > SL), OV_SLOTS)
    new_n_l = torch.clamp_max(new_n_l, SL)
    pi = PCH.index
    lch = []
    if lc:
        # pair-state epilogue (finishChanging / abortChanging): promote
        # finishing reals' shadows, unlink broken pairs, integrate the
        # lateral offset of surviving changing reals
        occ_l = torch.arange(SL, device=dev)[:, None, None] < rs.n_l[None]
        chg_real = occ_l & rs.l_chg & ~rs.l_sh
        clear = lcc["unlink_real"] | lcc["promote"] | lcc["unlink_sh"]
        off_u = torch.where(clear, 0.0, torch.where(
            chg_real, lcc["new_off"] * rs.l_dir.to(F32), rs.l_off))
        sh_u = rs.l_sh & ~(lcc["promote"] | lcc["unlink_sh"])
        chg_u = rs.l_chg & ~rs.l_sh & ~lcc["unlink_real"]
        dir_u = torch.where(sh_u | chg_u, rs.l_dir, 0).to(I32)
        zi = pi("zero")
        lch = ([(off_u, "f32", 0.0, zi, 0), (sh_u, "bool", 0.0, zi, 0),
                (chg_u, "bool", 0.0, zi, 0), (dir_u, "i32", 0.0, zi, 0),
                (rs.l_gap, "f32", 0.0, pi("gap"), 0)]
               + [(rs.l_rnrow[c], "i32", -1.0, pi(f"rn{c}"), 0)
                  for c in range(MAXLPR)]
               + [(rs.l_auxrow[c], "i32", -1.0, pi(f"ax{c}"), 0)
                  for c in range(MAXLPR)])
    louts = ring_commit(
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
         (rs.l_prev, "i32", -1.0, pi("prev"), 0)] + lch
        + ([] if uni else [(rs.l_tpl, "i32", 0.0, pi("tpl"), 0)]),
        None if lc else x_l, rs.n_l - totdel, cands, valid_ch=pi("valid"),
        sort_ch=pi("dis"), nsel=SAE, XK=cfg.XK, app_I=cfg.I, app_G=G,
        dmask=del_full if lc else None, XD=XD if lc else 0)
    (new_l_dis, new_l_speed, new_l_flow, new_l_route, new_l_rpos,
     new_l_enter, new_l_pri, new_l_uid, new_l_nxt, new_l_nxt3, new_l_last,
     new_l_prev) = louts[:12]
    lc_kw = {}
    if lc:
        lo = louts[12:]
        lc_kw = dict(l_off=lo[0], l_sh=lo[1], l_chg=lo[2], l_dir=lo[3],
                     l_gap=lo[4], l_rnrow=torch.stack(lo[5:5 + MAXLPR]),
                     l_auxrow=torch.stack(lo[5 + MAXLPR:5 + 2 * MAXLPR]),
                     k_gap=kouts[10])
    if not uni:
        lc_kw.update(l_tpl=louts[-1], k_tpl=kouts[-1])

    _span("new_state")
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
        n_l=new_n_l, n_k=new_n_k, blk=ex["blk"],
        phase=ex["phase"], phase_remain=ex["remain"],
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
        k_hascustom=torch.zeros((SK, LKp, B), dtype=torch.bool, device=dev),
        **lc_kw)
    if cfg.track_history:
        # end-of-step updateHistory on the committed state (the final
        # threadUpdateLeaderAndGap of nextStep, engine.cpp:581)
        new_rs = _update_history(cfg, new_rs)
    _span("p2_end")
    return new_rs, dbg


# ---------------------------------------------------------------------------
# entry points. The *_batched ones take trailing-batch state (leaves
# shape + (B,), batch_ring_state) and write it in place; the others take
# one env's state in the JAX package's shapes, run it as B = 1 and leave
# it as it was.
# ---------------------------------------------------------------------------

def _unsqueeze(x):
    return x[..., None]


def _batch1(rs: RingState) -> RingState:
    """One env's state as B = 1. The leaves the batched step writes in
    place (the admission's, R3, and the history ring) are copied: the
    single-env entries leave the caller's state as it was (the ring
    Engine reruns a step from it after a growth)."""
    b = rs.map(_unsqueeze)
    own = ADMIT_FIELDS + ("h_ring_num", "h_ring_ssum")
    return b.replace_fields(**{k: getattr(b, k).clone() for k in own
                               if getattr(b, k) is not None})


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
    rs_b, mid_b = ring_step_p1_batched(net, cfg, _batch1(rs), q)
    return rs_b.map(_squeeze), _map_mid(mid_b, _squeeze)


def ring_step_p2(net, cfg: RingConfig, rs: RingState, mid):
    mid_b = _map_mid(mid, _unsqueeze)
    # R2 clamps the new distances in place: the caller's mid stays as it was
    mid_b["new_dis_l"] = mid_b["new_dis_l"].clone()
    return ring_step_p2_batched(net, cfg, _batch1(rs), mid_b).map(_squeeze)


def ring_step(net, cfg: RingConfig, rs: RingState, q, debug: bool = False):
    """One Engine::nextStep on one env. With debug=True also returns the
    intermediates of both phases (tests only)."""
    rs1, mid, dbg1 = _notify_phase(net, cfg, _batch1(rs), q, debug)
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
