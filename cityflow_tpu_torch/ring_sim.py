"""Host side of the PyTorch ring simulator: builds the device tables,
the spawn queues and the initial state, and steps one env."""

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from cityflow_tpu_torch.carry import tables_from_numpy
from cityflow_tpu_torch.compiler.net import CompiledNet
from cityflow_tpu_torch.compiler.ring_net import build_ring, RingMeta
from cityflow_tpu_torch.compiler.spawn import SpawnGenerator
from cityflow_tpu_torch.core.ring import (
    RingConfig, RingState, init_ring_state, ring_step, P_LEN, P_MAXSPEED,
    P_MINGAP)
from cityflow_tpu_torch.device import resolve_device

# shadow inserts per lane and step for lane change with non-uniform
# templates: the JAX package's 2 is too few there (the mixed 30x30
# lane-change grid flags OV_REMOVE at 2); the most that grid asks of one
# lane in one step, warm-up and window, is 4 (chip_smoke.py [mixed-lc]
# measures it on every run and fails if it passes the cap)
TEMPLATE_LCI = 4


@dataclass
class RingSim:
    net: CompiledNet = None
    meta: RingMeta = None
    cfg: RingConfig = None
    tables: Dict = None          # device tensors
    q: Dict = None               # spawn queues (EL, QCAP) on the device
    state: RingState = None      # one env, no batch axis
    gen: SpawnGenerator = None
    device: object = None


def _flow_tpl_now(net: CompiledNet, tpl_params: np.ndarray) -> np.ndarray:
    """Flow -> template-index map, from the flow_params rows as they are
    now (a flow whose row matches no template maps to 0)."""
    fp = net.flow_params.astype(np.float32)
    eq = np.all(np.isclose(fp[:, None, :], tpl_params[None]), axis=2)
    return np.where(eq.any(1), eq.argmax(1), 0).astype(np.int32)


def _build_queues(gen: SpawnGenerator, meta: RingMeta, horizon: int,
                  qcap_round: int = 256, flow_tpl=None):
    """Group the host-replayed spawn rows (mt19937 stream, compiler/spawn.py)
    into per-entry-lane FIFO queues. Row uid = global row index. With
    `flow_tpl` (non-uniform templates) a "tpl" column holds each row's
    template index."""
    gen.extend(horizon)
    t = gen.arrays()
    EL = len(meta.entry_lanes)
    el_index = {int(p): i for i, p in enumerate(meta.entry_lanes)}
    per = [[] for _ in range(EL)]
    lane_pos = meta.lane_pos
    for r in range(len(t["step"])):
        fd = int(t["first_drv"][r])
        p = int(lane_pos[fd])
        e = el_index.get(p)
        if e is None:
            raise ValueError("spawn row on a lane outside the entry set "
                             "(push_vehicle with a new road needs a rebuild)")
        per[e].append(r)
    qcap = max((len(v) for v in per), default=1) or 1
    qcap = ((qcap + qcap_round - 1) // qcap_round) * qcap_round
    q = {k: np.full((EL, qcap), -1, np.int32)
         for k in ("step", "flow", "pri", "route", "uid")}
    for e, rows in enumerate(per):
        for j, r in enumerate(rows):
            q["step"][e, j] = t["step"][r]
            q["flow"][e, j] = t["flow"][r]
            q["pri"][e, j] = t["priority"][r]
            q["route"][e, j] = t["route"][r]
            q["uid"][e, j] = r
    if flow_tpl is not None:
        q["tpl"] = np.where(
            q["flow"] >= 0,
            flow_tpl[np.clip(q["flow"], 0, len(flow_tpl) - 1)],
            0).astype(np.int32)
    return q


def build_sim(net: CompiledNet, horizon: int = 512,
              sl: Optional[int] = None, skc: Optional[int] = None,
              device=None, sk: Optional[int] = None) -> RingSim:
    """Tables, queues and initial state for `net` on `device` (None means
    "cuda"; pass device="cpu" for the plain PyTorch path on the CPU).
    sl / sk override the lane / link ring slots (default: the longest
    drivable's capacity; with non-uniform templates the capacity of the
    template that packs densest). The shadow inserts per lane per step are
    RingConfig's 2, as in the JAX package's build_sim, but with lane
    change and non-uniform templates the most L3 takes, 8: the mixed
    30x30 lane-change grid sends more than 2 changers into a lane in a
    step. Below the cap its value changes nothing; above it the step
    flags OV_REMOVE."""
    dev = resolve_device(device)
    cfgj = net.host.config
    interval = float(cfgj["interval"])
    lane_change = bool(cfgj.get("laneChange", False))
    tb, meta = build_ring(net, interval)
    if not meta.supported:
        raise ValueError(f"ring layout unsupported: {meta.unsupported_reason}")
    if meta.uniform_params:
        p = meta.param_row
        min_len = float(p[P_LEN]) + float(p[P_MINGAP])
        max_spd = float(p[P_MAXSPEED])
        params = tuple(float(v) for v in meta.param_row)
    else:
        # capacity and exit-hop bounds from the worst-case template; the
        # scalar parameters are NaN, so a use site that misses the per-slot
        # templates yields NaN instead of simulating template 0
        used = np.asarray(tb["tpl_params"])
        if not np.isfinite(used).all():
            # the JAX one-hot einsum turns 0 * inf into NaN where T1 reads
            # the entry: the two agree only on finite parameters
            raise ValueError("vehicle template parameters must be finite")
        min_len = float((used[:, P_LEN] + used[:, P_MINGAP]).min())
        max_spd = float(used[:, P_MAXSPEED].max())
        params = tuple([float("nan")] * 12)
    lane_cap = int(np.ceil(np.asarray(tb["ln_len"]).max() / min_len)) + 2
    link_cap = int(np.ceil(np.asarray(tb["lk_len"]).max() / min_len)) + 2
    SL = sl if sl is not None else lane_cap
    SK = sk if sk is not None else link_cap
    xk = max(2, int(np.ceil(max_spd * interval / min_len)))

    cfg = RingConfig(
        interval=interval, I=meta.I, G=meta.G, T=meta.T,
        LPI=meta.LPI, OL=meta.OL, IL=meta.IL, KC=meta.KC,
        KIN=meta.KIN, KOUT=meta.KOUT, LNp=meta.LNp, LKp=meta.LKp,
        SL=SL, SK=SK, AP=max(2, xk), XK=xk, SA=4,
        type_ranges=meta.type_ranges,
        params=params,
        uniform=bool(meta.uniform_params), TP=int(meta.TP),
        rl_traffic_light=bool(cfgj["rlTrafficLight"]),
        SKC=(skc if skc is not None else 4),
        MAXLPR=int(np.asarray(tb["route_next"]).shape[2]),
        lane_change=lane_change,
        **({} if meta.uniform_params or not lane_change
           else dict(LCI=TEMPLATE_LCI)),
        track_history=(str(cfgj.get("routerType", "LENGTH")).upper()
                       == "DURATION"))

    gen = SpawnGenerator(net, int(cfgj["seed"]), interval)
    q = _build_queues(gen, meta, horizon,
                      flow_tpl=None if cfg.uniform
                      else _flow_tpl_now(net, np.asarray(tb["tpl_params"])))
    st = init_ring_state(cfg, tb, len(meta.entry_lanes), dev)
    tables = tables_from_numpy(tb, dev, cfg)
    qd = {k: torch.as_tensor(v, device=dev) for k, v in q.items()}
    return RingSim(net=net, meta=meta, cfg=cfg, tables=tables, q=qd,
                   state=st, gen=gen, device=dev)


def step(sim: RingSim):
    """Advance the single-env state by one step."""
    sim.state = ring_step(sim.tables, sim.cfg, sim.state, sim.q)
    return sim.state


def rebuild_queues(sim: RingSim, gen: SpawnGenerator, horizon: int):
    """Re-derive the per-entry-lane queues from (a longer prefix of) the
    spawn stream. The stream replay is deterministic, so the per-lane
    grouping of the rows already consumed is unchanged and the live
    `el_cursor` values stay valid; only new rows append."""
    q = _build_queues(gen, sim.meta, horizon,
                      flow_tpl=None if sim.cfg.uniform
                      else _flow_tpl_now(
                          sim.net,
                          sim.tables["tpl_params"].cpu().numpy()))
    sim.q = {k: torch.as_tensor(v, device=sim.device) for k, v in q.items()}
    sim.gen = gen
    return sim


# fill values of the slot channels a ring growth appends
_GROW_L = dict(l_dis=0.0, l_speed=0.0, l_enter=0.0, l_custom=0.0,
               l_off=0.0, l_gap=0.0, l_yv=0.0, l_flow=0, l_route=0,
               l_rpos=0, l_nxt=-1, l_nxt3=-1, l_prev=-1, l_pri=0, l_uid=-1,
               l_dir=0, l_last=False, l_hascustom=False, l_sh=False,
               l_chg=False, l_tpl=0)
_GROW_K = dict(k_dis=0.0, k_speed=0.0, k_enter=0.0, k_custom=0.0,
               k_gap=0.0, k_flow=0, k_route=0, k_rpos=0, k_entll=0,
               k_pri=0, k_uid=-1, k_nxtl=-1, k_hascustom=False, k_tpl=0)


def grow_slots(sim: RingSim, dsl: int = 0, dsk: int = 0):
    """Capacity growth: the rings are front-prefix compact (slots >= n are
    empty), so appending empty tail slots (dsl lane slots, dsk link
    slots) keeps the state. New tensors: a snapshot keeps its own."""
    import dataclasses
    if not dsl and not dsk:
        return sim
    st = sim.state

    def pad(a, n, fill, axis=0):
        shape = list(a.shape)
        shape[axis] = n
        return torch.cat([a, torch.full(shape, fill, dtype=a.dtype,
                                        device=a.device)], dim=axis)
    kw = {}
    for grow, table in ((dsl, _GROW_L), (dsk, _GROW_K)):
        if grow:
            for n, fill in table.items():
                if getattr(st, n) is not None:
                    kw[n] = pad(getattr(st, n), grow, fill)
    if dsl and st.l_rnrow is not None:
        kw["l_rnrow"] = pad(st.l_rnrow, dsl, -1, axis=1)
        kw["l_auxrow"] = pad(st.l_auxrow, dsl, -1, axis=1)
    sim.state = st.replace_fields(**kw)
    sim.cfg = dataclasses.replace(sim.cfg, SL=sim.cfg.SL + dsl,
                                  SK=sim.cfg.SK + dsk)
    return sim


def _fill_cross_drivable_leaders(sim, c, out, lead, nl, nk, ls, lp, ks, kp,
                                 idx_l, idx_k):
    """The reference's Vehicle::updateLeaderAndGap forward walk for the
    vehicles at the front of their ring (vehicle.cpp:157-196): the routed
    next drivables in order; at a lanelink hop every lanelink leaving the
    previous lane counts (the overlapping-lanelink rule, vehicle.cpp:
    170-180) and the least-gap rear vehicle wins; the walk stops once the
    distance passes maxSpeed^2 / (2 usualNegAcc) + 2 maxSpeed interval. It
    sees as far as the route the slot carries (nxt, its end lane, nxt3,
    that one's end lane); with the default templates the distance bound
    (~89 m) ends it inside that on any net with lanes over ~60 m."""
    m = sim.meta
    net = sim.net
    L = net.num_lanes
    LNp = m.pos_lane.shape[0]
    fronts = np.nonzero(lead[:nl + nk] < 0)[0]
    if not len(fronts):
        return
    lk_end = sim.tables["lk_end_lane"].cpu().numpy()
    if m.uniform_params:
        p_row = np.asarray(m.param_row, np.float64)
        tpl_all = None
        tpp = None
    else:
        tpp = sim.tables["tpl_params"].cpu().numpy().astype(np.float64)
        tpl_all = np.concatenate(
            [c["l_tpl"][ls, lp], c["k_tpl"][ks, kp]]).astype(np.int64)
        p_row = None
    # the rearmost occupied row per ring lane / link position
    last_l = np.full(LNp, -1, np.int64)
    for pos in np.nonzero(c["n_l"] > 0)[0]:
        last_l[pos] = idx_l[int(c["n_l"][pos]) - 1, pos]
    LKp = m.pos_link.shape[0]
    last_k = np.full(LKp, -1, np.int64)
    for pos in np.nonzero(c["n_k"] > 0)[0]:
        last_k[pos] = idx_k[int(c["n_k"][pos]) - 1, pos]
    # ring lane position -> ring link positions of the lanelinks leaving it
    links_from = {}
    for k_orig in range(net.num_links):
        sl_pos = int(m.lane_pos[net.ll_start[k_orig]])
        links_from.setdefault(sl_pos, []).append(int(m.link_pos[k_orig]))

    def len_row(r):
        return float(p_row[P_LEN]) if tpl_all is None else \
            float(tpp[tpl_all[r], P_LEN])

    def lane_len(pos):
        return float(net.drv_len[m.pos_lane[pos]])

    def link_len(pos):
        return float(net.drv_len[L + m.pos_link[pos]])

    interval = float(sim.cfg.interval)
    dis = out["dis"]
    for i in fronts:
        if tpl_all is None:
            ms, una = float(p_row[P_MAXSPEED]), float(p_row[6])
        else:
            ms = float(tpp[tpl_all[i], P_MAXSPEED])
            una = float(tpp[tpl_all[i], 6])
        bound = ms * ms / una / 2 + ms * interval * 2
        # the next drivables: (kind, ring pos[, the previous lane's pos])
        chain = []
        if i < nl:
            cur_len = lane_len(lp[i])
            v0 = int(c["l_nxt"][ls[i], lp[i]])
            if v0 >= LNp:
                kpos0 = v0 - LNp
                chain.append(("link", kpos0, int(lp[i])))
                el = int(lk_end[kpos0])
                if el >= 0:
                    chain.append(("lane", el))
                    v3 = int(c["l_nxt3"][ls[i], lp[i]])
                    if v3 >= LNp:
                        chain.append(("link", v3 - LNp, el))
                        el3 = int(lk_end[v3 - LNp])
                        if el3 >= 0:
                            chain.append(("lane", el3))
        else:
            cur_len = link_len(kp[i - nl])
            el = int(lk_end[kp[i - nl]])
            if el >= 0:
                chain.append(("lane", el))
                v3 = int(c["k_nxtl"][ks[i - nl], kp[i - nl]])
                if v3 >= LNp:
                    chain.append(("link", v3 - LNp, el))
                    el3 = int(lk_end[v3 - LNp])
                    if el3 >= 0:
                        chain.append(("lane", el3))
        dis_rem = cur_len - float(dis[i])
        found = -1
        for item in chain:
            if item[0] == "link":
                _, kpos, prevl = item
                best_gap = None
                for k2 in links_from.get(prevl, ()):
                    r2 = int(last_k[k2])
                    if r2 >= 0:
                        g2 = dis_rem + float(dis[r2]) - len_row(r2)
                        if best_gap is None or g2 < best_gap:
                            best_gap, found = g2, r2
                if found >= 0:
                    break
                dis_rem += link_len(kpos)
            else:
                r2 = int(last_l[item[1]])
                if r2 >= 0:
                    found = r2
                    break
                dis_rem += lane_len(item[1])
            if dis_rem > bound:
                break
        if found >= 0:
            lead[i] = found


def fetch_full(sim: RingSim, gen: Optional[SpawnGenerator] = None):
    """The whole host view in the gen-1 engine's cache shape
    (engine.Engine._fetch): one row per live vehicle (lane slots first,
    then link slots) and one per spawned vehicle still waiting in a queue.
    Extra keys: kind / pos / slot (where a mutation writes back: kind 0
    lane ring, 1 link ring, 2 queue), len / width (the template's).
    Vectorised numpy over one device-to-host copy of the state."""
    m = sim.meta
    st = sim.state
    cfg = sim.cfg
    lc = cfg.lane_change
    names = ["n_l", "n_k", "step", "l_uid", "l_dis", "l_speed", "l_route",
             "l_rpos", "l_enter", "l_pri", "l_prev", "l_custom",
             "l_hascustom", "l_nxt", "l_nxt3",
             "k_uid", "k_dis", "k_speed", "k_route", "k_rpos", "k_enter",
             "k_pri", "k_custom", "k_hascustom", "k_nxtl", "el_cursor"]
    if lc:
        names += ["l_sh", "l_dir", "l_off", "l_gap", "k_gap"]
    if not cfg.uniform:
        names += ["l_tpl", "k_tpl"]
    c = {n: getattr(st, n).cpu().numpy() for n in names}
    SL, LNp = c["l_uid"].shape
    SK, LKp = c["k_uid"].shape
    now = int(c["step"])
    L = sim.net.num_lanes

    lmask = (np.arange(SL)[:, None] < c["n_l"][None, :]) \
        & (m.pos_lane >= 0)[None, :]
    kmask = (np.arange(SK)[:, None] < c["n_k"][None, :]) \
        & (m.pos_link >= 0)[None, :]
    ls, lp = np.nonzero(lmask)
    ks, kp = np.nonzero(kmask)
    nl, nk = len(ls), len(ks)

    def litem(name):
        return c[name][ls, lp]

    def kitem(name):
        return c[name][ks, kp]

    out = {}
    out["kind"] = np.concatenate([np.zeros(nl, np.int32),
                                  np.ones(nk, np.int32)])
    out["pos"] = np.concatenate([lp.astype(np.int32), kp.astype(np.int32)])
    out["slot"] = np.concatenate([ls.astype(np.int32), ks.astype(np.int32)])
    out["drv"] = np.concatenate([m.pos_lane[lp],
                                 L + m.pos_link[kp]]).astype(np.int32)
    for g1, ln, kn in (("dis", "l_dis", "k_dis"),
                       ("speed", "l_speed", "k_speed"),
                       ("route", "l_route", "k_route"),
                       ("enter_time", "l_enter", "k_enter"),
                       ("priority", "l_pri", "k_pri"),
                       ("uid", "l_uid", "k_uid"),
                       ("custom_speed", "l_custom", "k_custom"),
                       ("has_custom", "l_hascustom", "k_hascustom")):
        out[g1] = np.concatenate([litem(ln), kitem(kn)])
    # k_rpos is the route position before the transfer: the gen-1
    # route_pos of a lanelink vehicle
    out["route_pos"] = np.concatenate([litem("l_rpos"), kitem("k_rpos")])
    prev_lane = c["l_prev"][ls, lp]
    pl = np.full(nl, -1, np.int64)
    pv = prev_lane >= LNp
    pl[pv] = L + m.pos_link[np.clip(prev_lane[pv] - LNp, 0, LKp - 1)]
    pu = (prev_lane >= 0) & ~pv
    pl[pu] = m.pos_lane[np.clip(prev_lane[pu], 0, LNp - 1)]
    out["prev_drv"] = np.concatenate(
        [pl, np.full(nk, -1, np.int64)]).astype(np.int32)
    out["is_shadow"] = np.concatenate(
        [litem("l_sh"), np.zeros(nk, bool)]) if lc \
        else np.zeros(nl + nk, bool)
    out["offset"] = np.concatenate(
        [litem("l_off"), np.zeros(nk)]) if lc else np.zeros(nl + nk)
    out["lc_last_dir"] = np.concatenate(
        [litem("l_dir"), np.zeros(nk, np.int32)]).astype(np.int32) if lc \
        else np.zeros(nl + nk, np.int32)
    out["gap"] = np.concatenate(
        [litem("l_gap"), kitem("k_gap")]) if lc else np.zeros(nl + nk)
    # the order in a ring is the front-to-back list order
    out["list_seq"] = out["slot"].astype(np.int32)
    # leader: the slot above in the same ring; a vehicle at the front of
    # its ring gets the reference's forward walk across drivables
    lead = np.full(nl + nk, -1, np.int64)
    idx_l = np.full((SL, LNp), -1, np.int64)
    idx_l[ls, lp] = np.arange(nl)
    above = ls > 0
    lead[:nl][above] = idx_l[ls[above] - 1, lp[above]]
    idx_k = np.full((SK, LKp), -1, np.int64)
    idx_k[ks, kp] = nl + np.arange(nk)
    above = ks > 0
    lead[nl:][above] = idx_k[ks[above] - 1, kp[above]]
    _fill_cross_drivable_leaders(sim, c, out, lead, nl, nk, ls, lp, ks, kp,
                                 idx_l, idx_k)
    out["leader"] = lead.astype(np.int32)
    # partner: the row with the same uid and the other shadow flag
    part = np.full(nl + nk, -1, np.int32)
    if lc and nl:
        keyed = {(int(out["uid"][i]), bool(out["is_shadow"][i])): i
                 for i in range(nl)}
        for i in range(nl):
            j = keyed.get((int(out["uid"][i]), not bool(out["is_shadow"][i])))
            if j is not None and (out["lc_last_dir"][i]
                                  or out["lc_last_dir"][j]):
                part[i] = j
    out["partner"] = part
    out["running"] = np.ones(nl + nk, bool)

    # spawned vehicles still in a queue (gen-1: active & ~running); the
    # spawn of step s runs inside the (s + 1)-th step, so after `now`
    # steps the rows of steps < now exist in the reference's pool
    qh = {k: v.cpu().numpy() for k, v in sim.q.items()}
    QCAP = qh["step"].shape[1]
    cur = c["el_cursor"]
    col = np.arange(QCAP)[None, :]
    wmask = (col >= cur[:, None]) & (qh["step"] >= 0) & (qh["step"] < now)
    we, wj = np.nonzero(wmask)
    nw = len(we)
    if nw:
        wrow = {k: qh[k][we, wj] for k in qh}
        pad = {
            "kind": np.full(nw, 2, np.int32), "pos": we.astype(np.int32),
            "slot": wj.astype(np.int32), "drv": np.full(nw, -1, np.int32),
            "dis": np.zeros(nw), "speed": np.zeros(nw),
            "route": wrow["route"], "route_pos": np.zeros(nw, np.int32),
            "enter_time": wrow["step"].astype(np.float64) * cfg.interval,
            "priority": wrow["pri"], "uid": wrow["uid"],
            "custom_speed": np.zeros(nw), "has_custom": np.zeros(nw, bool),
            "prev_drv": np.full(nw, -1, np.int32),
            "is_shadow": np.zeros(nw, bool), "offset": np.zeros(nw),
            "lc_last_dir": np.zeros(nw, np.int32), "gap": np.zeros(nw),
            "list_seq": np.zeros(nw, np.int32),
            "leader": np.full(nw, -1, np.int32),
            "partner": np.full(nw, -1, np.int32),
            "running": np.zeros(nw, bool),
        }
        for k in out:
            out[k] = np.concatenate([out[k], pad[k]])
    n = nl + nk + nw
    out["active"] = np.ones(n, bool)
    if m.uniform_params:
        p = m.param_row
        out["len"] = np.full(n, float(p[P_LEN]))
        out["width"] = np.full(n, float(p[2]))
    else:
        tpl = np.concatenate(
            [c["l_tpl"][ls, lp], c["k_tpl"][ks, kp],
             wrow["tpl"] if nw else np.zeros(0, np.int32)]).astype(np.int64)
        tpp = sim.tables["tpl_params"].cpu().numpy()
        out["len"] = tpp[tpl, P_LEN].astype(np.float64)
        out["width"] = tpp[tpl, 2].astype(np.float64)
    return out


def fetch_vehicles(sim: RingSim):
    """{uid: (drivable, dis, speed)} of every running vehicle, a shadow's
    uid with bit 30 set (the gen-1 convention)."""
    m = sim.meta
    st = sim.state
    lc = sim.cfg.lane_change
    names = ["n_l", "n_k", "l_uid", "l_dis", "l_speed", "k_uid", "k_dis",
             "k_speed"] + (["l_sh"] if lc else [])
    c = {n: getattr(st, n).cpu().numpy() for n in names}
    out = {}
    L = sim.net.num_lanes
    for pos in range(m.LNp):
        lane = m.pos_lane[pos]
        if lane < 0:
            continue
        for s in range(int(c["n_l"][pos])):
            uid = int(c["l_uid"][s, pos])
            if lc and bool(c["l_sh"][s, pos]):
                uid |= 1 << 30
            out[uid] = (int(lane), float(c["l_dis"][s, pos]),
                        float(c["l_speed"][s, pos]))
    for pos in range(m.LKp):
        link = m.pos_link[pos]
        if link < 0:
            continue
        for s in range(int(c["n_k"][pos])):
            out[int(c["k_uid"][s, pos])] = (
                int(L + link), float(c["k_dis"][s, pos]),
                float(c["k_speed"][s, pos]))
    return out
