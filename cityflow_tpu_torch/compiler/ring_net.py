"""Gen-2 "ring" scenario tables: per-drivable slot layout grouped by
intersection, with type-shared local operators.

A copy of the JAX package's compiler/ring_net.py (the tables are the same,
leaf for leaf) plus `index_tables`, which turns every one-hot operator into
the int32 gather index that the PyTorch port applies instead of an einsum.

  lanes: (SL, LNp) where LNp = OL * I   (out-slot-major, intersection-minor)
  links: (SK, LKp) where LKp = LPI * G  (link-slot-major, group-minor)

Slot 0 is the FRONT vehicle (largest distance); occupied slots are the
prefix [0, n). Within a drivable the reference's `std::list` order is then
positional: leader = slot s-1 (a static shift), admission = append at n,
front exits = prefix shift-out.

Intersections with identical local structure share one TYPE, so every
cross-local operator (notify candidate maps, the foe-side exchange of
Cross::canPass, availability masks) is a small type-shared one-hot matrix.
Each row of those matrices holds at most one 1 (checked in
`index_tables`), so applying one is a gather.
"""

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from cityflow_tpu_torch.compiler.net import CompiledNet

INT_MAX = 2**31 - 1


@dataclass
class RingMeta:
    """Host-side metadata (shapes, orderings, id maps)."""
    I: int = 0            # all intersections (real first, then the rest)
    G: int = 0            # real (linked) intersections
    T: int = 0            # intersection types
    LPI: int = 0          # max links per real intersection
    OL: int = 0           # max out-lanes (lanes starting) per intersection
    IL: int = 0           # max in-lanes (lanes ending) per real intersection
    KC: int = 0           # max crosses per link
    KIN: int = 0          # max in-links per lane
    MAXRL: int = 0        # max roadlinks per intersection
    LNp: int = 0          # padded lane axis = OL * I
    LKp: int = 0          # padded link axis = LPI * G
    type_ranges: Tuple[Tuple[int, int], ...] = ()   # [g0, g1) per type
    # id maps (host numpy)
    lane_pos: np.ndarray = None    # (L,)  global lane -> flat ring pos
    pos_lane: np.ndarray = None    # (LNp,) flat ring pos -> global lane (-1)
    link_pos: np.ndarray = None    # (LL,) global link -> flat ring pos
    pos_link: np.ndarray = None    # (LKp,) -> global link (-1)
    new2old_inter: np.ndarray = None  # (I,) new inter axis -> original index
    supported: bool = True
    unsupported_reason: str = ""
    scan_bound: float = 0.0
    entry_lanes: np.ndarray = None  # (EL,) flat ring lane pos of entry lanes
    uniform_params: bool = False    # all flow templates identical
    param_row: np.ndarray = None    # (12,) the single template if uniform
    TP: int = 1                     # distinct vehicle templates (>=1)
    foe_via_perm: bool = True       # einsum foe exchange vs flat gather
    KOUT: int = 1                   # max out-links per in-lane
    fwd_shifts: tuple = ()          # shift plan offsets (lane -> in-lane)
    bwd_shifts: tuple = ()          # shift plan offsets (in-lane -> lane)
    inn_shifts: tuple = ()          # shift plan offsets (lane -> inner lane)
    out_shifts: tuple = ()          # shift plan offsets (lane -> outer lane)


def _veh_bound(net: CompiledNet, interval: float) -> float:
    """Leader-scan lookahead bound, max over flow templates
    (reference vehicle.cpp:162-164: maxSpeed^2/(2*usualNegAcc)+2*maxSpeed*dt)."""
    from cityflow_tpu_torch.compiler.net import P_MAXSPEED, P_USUALNEGACC
    fp = net.flow_params
    used = net.flow_route >= 0
    if not used.any():
        return 0.0
    ms = fp[used, P_MAXSPEED]
    un = fp[used, P_USUALNEGACC]
    return float(np.max(ms * ms / un / 2 + ms * interval * 2))


def build_ring(net: CompiledNet, interval: float) -> Tuple[Dict[str, np.ndarray], RingMeta]:
    """Build ring tables from a CompiledNet. Returns (device tables, meta)."""
    hn = net.host.net
    L, LL, I = net.num_lanes, net.num_links, net.num_inters
    meta = RingMeta()

    # ---- intersection ordering: real (linked) first --------------------------
    cnt_links = np.bincount(net.ll_inter, minlength=I) if LL else np.zeros(I, np.int64)
    real = [i for i in range(I) if cnt_links[i] > 0]
    rest = [i for i in range(I) if cnt_links[i] == 0]
    G = len(real)

    # ---- per-intersection local structure ------------------------------------
    # links of inter i in global (roadlink x lanelink) order
    inter_links: Dict[int, List[int]] = {i: [] for i in range(I)}
    for k in range(LL):
        inter_links[int(net.ll_inter[k])].append(k)
    LPI = max((len(v) for v in inter_links.values()), default=1) or 1
    KC = net.lnk_cross_d.shape[1] if LL else 1

    # out-lanes per intersection (lanes starting at i)
    out_lanes: Dict[int, List[int]] = {i: [] for i in range(I)}
    in_lanes_all: Dict[int, List[int]] = {i: [] for i in range(I)}
    for lane in hn.lanes:
        si = lane.road.start_intersection
        ei = lane.road.end_intersection
        if si is not None:
            out_lanes[si.index].append(lane.index)
        if ei is not None:
            in_lanes_all[ei.index].append(lane.index)

    # canonical local slot orders. For type consistency both are derived from
    # the intersection's own link list: first-seen start lanes define IL slots,
    # first-seen end lanes define the leading OL slots (remaining out-lanes
    # appended by (road, lane) order).
    il_of: Dict[int, Dict[int, int]] = {}
    ol_of: Dict[int, Dict[int, int]] = {}
    for i in range(I):
        ils: Dict[int, int] = {}
        ols: Dict[int, int] = {}
        for k in inter_links[i]:
            s = int(net.ll_start[k])
            e = int(net.ll_end[k])
            if s not in ils:
                ils[s] = len(ils)
            if e not in ols:
                ols[e] = len(ols)
        for lane_idx in sorted(out_lanes[i],
                               key=lambda x: (hn.lanes[x].road.index,
                                              hn.lanes[x].lane_index)):
            if lane_idx not in ols:
                ols[lane_idx] = len(ols)
        il_of[i] = ils
        ol_of[i] = ols
    OL = max((len(v) for v in ol_of.values()), default=1) or 1
    IL = max((len(il_of[i]) for i in real), default=1) or 1
    MAXRL = net.phase_rl_avail.shape[1]

    # ---- canonical cross order per link --------------------------------------
    # The reference sorts a link's crosses ASC by distance; absolute-coordinate
    # fp noise makes tie order differ between geometrically identical
    # intersections. Re-sort by (f32 distance, foe local link, f32 foe dist)
    # so identical intersections produce identical tables (fast mode only —
    # cross order is semantically a distance order; ties are fp-noise).
    lpi_of = {}         # global link -> local lpi
    for i in range(I):
        for lpi, k in enumerate(inter_links[i]):
            lpi_of[k] = lpi
    cross_order = np.full((max(LL, 1), KC), -1, np.int64)   # new kc -> old kc
    if LL:
        d32 = net.lnk_cross_d.astype(np.float32)
        valid = net.lnk_cross_valid
        foe_pos = net.lnk_cross_foe_pos
        foe_link_g = foe_pos // KC
        foe_kc_g = foe_pos % KC
        for k in range(LL):
            keys = []
            for c in range(KC):
                if not valid[k, c]:
                    continue
                fl = int(foe_link_g[k, c])
                fc = int(foe_kc_g[k, c])
                keys.append((float(d32[k, c]), lpi_of[fl],
                             float(d32[fl, fc]), c))
            keys.sort()
            for newc, (_, _, _, oldc) in enumerate(keys):
                cross_order[k, newc] = oldc

    def reorder(tbl, fill):
        """Apply canonical cross order to an (LL, KC) table."""
        out = np.full_like(tbl, fill)
        for k in range(LL):
            for c in range(KC):
                o = cross_order[k, c]
                if o >= 0:
                    out[k, c] = tbl[k, o]
        return out

    if LL:
        cd = reorder(net.lnk_cross_d, 0.0)
        cvalid = cross_order >= 0
        cfoetype = reorder(net.lnk_cross_foetype, 0)
        # canonical foe slot: where did (cross, foe side) land after reorder?
        newpos = np.zeros((LL, KC), np.int64)  # old kc -> new kc
        for k in range(LL):
            for c in range(KC):
                o = cross_order[k, c]
                if o >= 0:
                    newpos[k, o] = c
        cfoe_link = reorder(net.lnk_cross_foe_pos // KC, 0)
        cfoe_oldkc = reorder(net.lnk_cross_foe_pos % KC, 0)
        cfoe_kc = np.zeros((LL, KC), np.int64)
        for k in range(LL):
            for c in range(KC):
                if cvalid[k, c]:
                    cfoe_kc[k, c] = newpos[int(cfoe_link[k, c]),
                                           int(cfoe_oldkc[k, c])]
    else:
        cd = np.zeros((1, KC))
        cvalid = np.zeros((1, KC), bool)
        cfoetype = np.zeros((1, KC), np.int64)
        cfoe_link = np.zeros((1, KC), np.int64)
        cfoe_kc = np.zeros((1, KC), np.int64)

    # ---- type signatures + g reorder -----------------------------------------
    S2 = LPI * KC
    sig_of_g = []
    for i in real:
        links = inter_links[i]
        n = len(links)
        rows = []
        for k in links:
            foe_s2 = tuple(
                (lpi_of[int(cfoe_link[k, c])] * KC + int(cfoe_kc[k, c]))
                if cvalid[k, c] else -1 for c in range(KC))
            rows.append((
                int(net.ll_type[k]), bool(net.ll_is_turn[k]),
                int(net.ll_rl_local[k]),
                il_of[i][int(net.ll_start[k])],
                ol_of[i][int(net.ll_end[k])],
                foe_s2))
        # lane append structure: per end-lane ol slot, ordered in-link lpis
        app: Dict[int, List[int]] = {}
        for lpi, k in enumerate(links):
            app.setdefault(rows[lpi][4], []).append(lpi)
        app_sig = tuple(sorted((ol, tuple(v)) for ol, v in app.items()))
        sig_of_g.append((n, tuple(rows), app_sig))

    sig_index: Dict = {}
    for s in sig_of_g:
        if s not in sig_index:
            sig_index[s] = len(sig_index)
    T = len(sig_index)
    order = sorted(range(G), key=lambda g: (sig_index[sig_of_g[g]], g))
    real_sorted = [real[g] for g in order]
    new2old = np.array(real_sorted + rest, np.int64)
    type_of_g = [sig_index[sig_of_g[g]] for g in order]
    ranges = []
    for t in range(T):
        gs = [g for g in range(G) if type_of_g[g] == t]
        ranges.append((gs[0], gs[-1] + 1))
        assert gs == list(range(gs[0], gs[-1] + 1))
    meta.type_ranges = tuple((int(a), int(b)) for a, b in ranges)

    # ---- flat placements ------------------------------------------------------
    LNp = OL * I
    LKp = LPI * G
    lane_pos = np.full(L, -1, np.int64)
    pos_lane = np.full(LNp, -1, np.int64)
    for q, i in enumerate(new2old):
        for lane_idx, ol in ol_of[int(i)].items():
            p = ol * I + q
            lane_pos[lane_idx] = p
            pos_lane[p] = lane_idx
    assert (lane_pos >= 0).all()
    link_pos = np.full(max(LL, 1), -1, np.int64)
    pos_link = np.full(LKp, -1, np.int64)
    for g in range(G):
        i = int(new2old[g])
        for lpi, k in enumerate(inter_links[i]):
            p = lpi * G + g
            link_pos[k] = p
            pos_link[p] = k
    if LL:
        assert (link_pos >= 0).all()

    KIN = 1
    for i in real:
        cnt: Dict[int, int] = {}
        for k in inter_links[i]:
            e = int(net.ll_end[k])
            cnt[e] = cnt.get(e, 0) + 1
        if cnt:
            KIN = max(KIN, max(cnt.values()))

    meta.I, meta.G, meta.T = I, G, T
    meta.LPI, meta.OL, meta.IL, meta.KC = LPI, OL, IL, KC
    meta.KIN, meta.MAXRL = KIN, MAXRL
    meta.LNp, meta.LKp = LNp, LKp
    meta.lane_pos, meta.pos_lane = lane_pos, pos_lane
    meta.link_pos, meta.pos_link = link_pos, pos_link
    meta.new2old_inter = new2old

    # ---- support check: leader-scan locality ---------------------------------
    bound = _veh_bound(net, interval)
    meta.scan_bound = bound
    lane_lens = np.array([ln.length for ln in hn.lanes]) if L else np.zeros(1)
    if L and lane_lens.min() <= bound:
        meta.supported = False
        meta.unsupported_reason = (
            f"lane length {lane_lens.min():.1f} <= scan bound {bound:.1f}: "
            "leader scan would cross two intersections")

    # ---- device tables --------------------------------------------------------
    tb: Dict[str, np.ndarray] = {}
    f32 = np.float32

    ln_len = np.zeros(LNp, f32)
    ln_maxspd = np.zeros(LNp, f32)
    ln_llocal = np.zeros(LNp, np.int32)
    ln_valid = np.zeros(LNp, bool)
    ln_g = np.full(LNp, -1, np.int32)          # end-inter group (real) else -1
    ln_width = np.zeros(LNp, f32)
    ln_inner = np.full(LNp, -1, np.int32)      # ring pos of laneIndex-1 lane
    ln_outer = np.full(LNp, -1, np.int32)      # ring pos of laneIndex+1 lane
    old2newq = {int(v): q for q, v in enumerate(new2old)}
    for lane in hn.lanes:
        p = lane_pos[lane.index]
        ln_len[p] = lane.length
        ln_maxspd[p] = lane.max_speed
        ln_llocal[p] = lane.lane_index
        ln_valid[p] = True
        ln_width[p] = lane.width
        road_lanes = lane.road.lanes
        if lane.lane_index > 0:
            ln_inner[p] = lane_pos[road_lanes[lane.lane_index - 1].index]
        if lane.lane_index + 1 < len(road_lanes):
            ln_outer[p] = lane_pos[road_lanes[lane.lane_index + 1].index]
        ei = lane.road.end_intersection
        if ei is not None and cnt_links[ei.index] > 0:
            g = old2newq[ei.index]
            assert g < G
            ln_g[p] = g
    tb["ln_len"] = ln_len
    tb["ln_maxspd"] = ln_maxspd
    tb["ln_llocal"] = ln_llocal
    tb["ln_valid"] = ln_valid
    tb["ln_g"] = ln_g
    tb["ln_width"] = ln_width
    tb["ln_inner"] = ln_inner
    tb["ln_outer"] = ln_outer
    # lane-change finish threshold (w_cur + w_target)/2 per direction
    # (engine.cpp:232-235); static per (lane, dir)
    wi = np.where(ln_inner >= 0, ln_width[np.clip(ln_inner, 0, None)], 0.0)
    wo = np.where(ln_outer >= 0, ln_width[np.clip(ln_outer, 0, None)], 0.0)
    tb["ln_maxoff_in"] = ((ln_width + wi) / 2).astype(f32)
    tb["ln_maxoff_out"] = ((ln_width + wo) / 2).astype(f32)

    lk_len = np.zeros(LKp, f32)
    lk_turn = np.zeros(LKp, bool)
    lk_type = np.zeros(LKp, np.int32)
    lk_valid = np.zeros(LKp, bool)
    lk_end_lane = np.full(LKp, -1, np.int32)   # flat ring lane pos
    lk_d = np.zeros((KC, LKp), f32)
    lk_cvalid = np.zeros((KC, LKp), bool)
    lk_foetype = np.zeros((KC, LKp), np.int32)
    lk_foelpi = np.zeros((KC, LKp), np.int32)
    for g in range(G):
        i = int(new2old[g])
        for lpi, k in enumerate(inter_links[i]):
            p = lpi * G + g
            lk_len[p] = net.drv_len[L + k]
            lk_turn[p] = net.ll_is_turn[k]
            lk_type[p] = net.ll_type[k]
            lk_valid[p] = True
            lk_end_lane[p] = lane_pos[int(net.ll_end[k])]
            lk_d[:, p] = cd[k]
            lk_cvalid[:, p] = cvalid[k]
            lk_foetype[:, p] = cfoetype[k]
            lk_foelpi[:, p] = [lpi_of[int(cfoe_link[k, c])] if cvalid[k, c]
                               else 0 for c in range(KC)]
    tb["lk_len"] = lk_len
    tb["lk_turn"] = lk_turn
    tb["lk_type"] = lk_type
    tb["lk_valid"] = lk_valid
    tb["lk_end_lane"] = lk_end_lane
    tb["lk_d"] = lk_d
    tb["lk_cvalid"] = lk_cvalid
    tb["lk_foetype"] = lk_foetype
    tb["lk_foelpi"] = lk_foelpi

    # shift-decomposition plan for a constant index map j -> idx[j]:
    # the top-K offsets (idx[j] - j) become masked static slices (free on
    # TPU), the residual tail stays a tiny gather. Grid topology puts ~97%
    # of the in-lane exchange on ~12 offsets.
    def shift_plan(idx: np.ndarray, max_groups: int = 16):
        n = len(idx)
        j = np.arange(n)
        valid = idx >= 0
        offs = idx.astype(np.int64) - j
        uo, cnts = np.unique(offs[valid], return_counts=True)
        order = np.argsort(-cnts)
        top = [int(uo[k]) for k in order[:max_groups]]
        gid = np.full(n, -1, np.int8)
        for k, o in enumerate(top):
            gid[valid & (offs == o)] = k
        res = valid & (gid < 0)
        res_j = np.nonzero(res)[0].astype(np.int32)
        res_src = idx[res].astype(np.int32)
        return tuple(top), gid, res_j, res_src

    # in-lane gather map: (IL, G) flat lane pos (-1 pad)
    in_src = np.full((IL, G), -1, np.int32)
    for g in range(G):
        i = int(new2old[g])
        for lane_idx, il in il_of[i].items():
            in_src[il, g] = lane_pos[lane_idx]
    tb["in_src"] = in_src
    # inverse: for each flat lane pos, its (il*G+g) slot or -1
    in_inv = np.full(LNp, -1, np.int32)
    for il in range(IL):
        for g in range(G):
            if in_src[il, g] >= 0:
                in_inv[in_src[il, g]] = il * G + g
    tb["in_inv"] = in_inv

    fwd_shifts, fwd_gid, fwd_rj, fwd_rs = shift_plan(in_src.reshape(-1))
    bwd_shifts, bwd_gid, bwd_rj, bwd_rs = shift_plan(in_inv)
    meta.fwd_shifts = fwd_shifts
    meta.bwd_shifts = bwd_shifts
    tb["fwd_gid"] = fwd_gid
    tb["fwd_res_j"] = fwd_rj
    tb["fwd_res_src"] = fwd_rs
    tb["bwd_gid"] = bwd_gid
    tb["bwd_res_j"] = bwd_rj
    tb["bwd_res_src"] = bwd_rs

    # lane -> inner/outer neighbor-lane permutations (lane change); grid
    # topology puts nearly all of both on a handful of +-I-style offsets
    inn_shifts, inn_gid, inn_rj, inn_rs = shift_plan(ln_inner)
    out_shifts, out_gid, out_rj, out_rs = shift_plan(ln_outer)
    meta.inn_shifts = inn_shifts
    meta.out_shifts = out_shifts
    tb["inn_gid"] = inn_gid
    tb["inn_res_j"] = inn_rj
    tb["inn_res_src"] = inn_rs
    tb["out_gid"] = out_gid
    tb["out_res_j"] = out_rj
    tb["out_res_src"] = out_rs

    # type-shared operators. The dense foe permutation (S2 x S2 one-hot,
    # applied on the MXU) is only worth materializing when S2 is small —
    # a single huge intersection (example net: S2 = 23k) instead uses a flat
    # constant-index gather, which is cheap at that scale.
    use_perm = S2 <= 1024
    meta.foe_via_perm = use_perm
    E_start = np.zeros((T, LPI, IL), f32)
    E_end = np.zeros((T, LPI, OL), f32)
    E_rl = np.zeros((T, LPI, MAXRL), f32)
    foe_perm = np.zeros((T, S2, S2), f32) if use_perm else None  # [dst, src]
    app_src = np.full((T, OL, KIN), -1, np.int32)     # lpi of kin-th in-link
    lk_start_il_t = np.zeros((T, LPI), np.int32)
    for t in range(T):
        g0 = meta.type_ranges[t][0]
        i = int(new2old[g0])
        links = inter_links[i]
        for lpi, k in enumerate(links):
            E_start[t, lpi, il_of[i][int(net.ll_start[k])]] = 1.0
            E_end[t, lpi, ol_of[i][int(net.ll_end[k])]] = 1.0
            E_rl[t, lpi, int(net.ll_rl_local[k])] = 1.0
            lk_start_il_t[t, lpi] = il_of[i][int(net.ll_start[k])]
            if use_perm:
                # s2 index is KC-major (kc*LPI + lpi): matches the step's
                # (KC, LPI, G) -> (KC*LPI, G) reshape
                for c in range(KC):
                    if cvalid[k, c]:
                        src = (int(cfoe_kc[k, c]) * LPI
                               + lpi_of[int(cfoe_link[k, c])])
                        foe_perm[t, c * LPI + lpi, src] = 1.0
            ol = ol_of[i][int(net.ll_end[k])]
            row = app_src[t, ol]
            j = int((row >= 0).sum())
            app_src[t, ol, j] = lpi
    tb["E_start"] = E_start
    tb["E_end"] = E_end
    tb["E_rl"] = E_rl
    if use_perm:
        tb["foe_perm"] = foe_perm
    else:
        # flat (KC, LKp) index into the kc-major flat (KC*LKp) field arrays
        fg = np.zeros((KC, LKp), np.int32)
        for g in range(G):
            i = int(new2old[g])
            for lpi, k in enumerate(inter_links[i]):
                p = lpi * G + g
                for c in range(KC):
                    fg[c, p] = (int(cfoe_kc[k, c]) * LKp
                                + lpi_of[int(cfoe_link[k, c])] * G + g) \
                        if cvalid[k, c] else 0
        tb["foe_gather"] = fg
    tb["app_src"] = app_src
    tb["lk_start_il_t"] = lk_start_il_t

    # E_app: one-hot selectors for the kin-th in-link of each out-lane
    E_app = np.zeros((T, KIN, OL, LPI), f32)
    for t in range(T):
        for olx in range(OL):
            for kin in range(KIN):
                lpi = app_src[t, olx, kin]
                if lpi >= 0:
                    E_app[t, kin, olx, lpi] = 1.0
    tb["E_app"] = E_app

    # out-links per in-lane, in Lane::laneLinks order (leader-scan overlap
    # rule, vehicle.cpp:170-180; gen-1 leader_scan cand_pack order)
    KOUT = 1
    for i in real:
        for lane_idx in il_of[i]:
            KOUT = max(KOUT, len(hn.lanes[lane_idx].lane_links))
    meta.KOUT = KOUT
    E_out = np.zeros((T, IL * KOUT, LPI), f32)
    out_valid = np.zeros((T, IL, KOUT), f32)
    for t in range(T):
        g0 = meta.type_ranges[t][0]
        i = int(new2old[g0])
        for lane_idx, il in il_of[i].items():
            for j, ll in enumerate(hn.lanes[lane_idx].lane_links):
                lpi = lpi_of[ll.index]
                E_out[t, il * KOUT + j, lpi] = 1.0
                out_valid[t, il, j] = 1.0
    tb["E_out"] = E_out
    # dense per-group out validity (types may differ across g)
    ovg = np.zeros((IL, KOUT, G), f32)
    for t, (g0, g1) in enumerate(meta.type_ranges):
        ovg[:, :, g0:g1] = out_valid[t][:, :, None]
    tb["out_valid_g"] = ovg

    # lights: per-group phase tables (indexed by new g axis)
    tb["g_phase_offset"] = net.phase_offset[new2old[:G]].astype(np.int32) \
        if G else np.zeros(0, np.int32)
    tb["g_n_phases"] = net.n_phases[new2old[:G]].astype(np.int32) \
        if G else np.zeros(0, np.int32)
    tb["phase_time"] = net.phase_time.astype(f32)
    tb["phase_rl_avail"] = net.phase_rl_avail.astype(f32)   # (TP, MAXRL)
    tb["i_n_phases"] = net.n_phases[new2old].astype(np.int32)
    tb["i_phase_offset"] = net.phase_offset[new2old].astype(np.int32)
    tb["i_virtual"] = net.inter_virtual[new2old]

    # routes in ring ids: lanes [0, LNp), links [LNp, LNp+LKp)
    rn = net.route_next_ll
    ring_next = np.where(rn >= L, -2, rn)      # temp
    ring_next = np.where(rn >= L,
                         LNp + link_pos[np.clip(rn - L, 0, max(LL - 1, 0))],
                         -1).astype(np.int32)
    tb["route_next"] = ring_next               # (NR, RLEN, MAXLPR)
    tb["route_len"] = net.route_len.astype(np.int32)

    # two-hop route table: for a vehicle entering the lane selected at
    # (rid, p, li), aux = ((nxt3 + 2) << 1) | is_last where nxt3 is the
    # link AFTER that lane's next link's end lane. Baked at compile time so
    # link->lane transfers need a single table gather instead of a chained
    # three-gather walk per transfer.
    NRr, RLENr, MAXLPRr = ring_next.shape
    lane_llocal_of_pos = np.zeros(LNp, np.int64)
    for lane in hn.lanes:
        lane_llocal_of_pos[lane_pos[lane.index]] = lane.lane_index
    aux = np.zeros((NRr, RLENr, MAXLPRr), np.int32)
    lk_end_lane_np = np.full(LKp, -1, np.int64)
    for g in range(G):
        i = int(new2old[g])
        for lpi, k in enumerate(inter_links[i]):
            lk_end_lane_np[lpi * G + g] = lane_pos[int(net.ll_end[k])]
    rl_np = net.route_len
    for rid in range(NRr):
        for p2 in range(RLENr):
            last2 = p2 >= (rl_np[rid] - 1) if rid < len(rl_np) else True
            for li in range(MAXLPRr):
                nxt = ring_next[rid, p2, li]
                nxt3 = -1
                if nxt >= 0:
                    el2 = lk_end_lane_np[nxt - LNp]
                    if el2 >= 0 and p2 + 1 < RLENr:
                        nxt3 = ring_next[rid, p2 + 1,
                                         int(lane_llocal_of_pos[el2])]
                aux[rid, p2, li] = ((nxt3 + 2) << 1) | int(bool(last2))
    tb["route_aux"] = aux

    tb["flow_params"] = net.flow_params.astype(f32)
    fp = net.flow_params[net.flow_route >= 0]
    meta_uniform = bool(len(fp) and (fp == fp[0]).all())
    meta.uniform_params = meta_uniform
    meta.param_row = fp[0].astype(np.float64) if meta_uniform else None
    # distinct-template table for the non-uniform path: per-slot template
    # indices ride the rings; params come back via a (..., TP) x (TP, 12)
    # one-hot einsum (MXU) instead of per-slot gathers. Dedupe over USED
    # flow rows only — flow_params carries zeroed headroom rows for
    # manual push_vehicle (engine.py), which are not templates
    uniq = np.unique(fp.astype(f32), axis=0) if len(fp) \
        else np.zeros((1, 12), f32)
    meta.TP = int(len(uniq))
    tb["tpl_params"] = uniq.astype(f32)               # (TP, 12)

    # entry lanes: all lanes of all flow first roads (ring pos)
    els = set()
    for flspec in net.host.flows:
        if flspec.route_id < 0:
            continue
        road = net.host.routes[flspec.route_id][0]
        for lane in road.lanes:
            els.add(int(lane_pos[lane.index]))
    entry = np.array(sorted(els), np.int64) if els else np.zeros(0, np.int64)
    meta.entry_lanes = entry
    tb["el_lane"] = entry.astype(np.int32)
    tb["lane_perm"] = lane_pos.astype(np.int32)   # original lane id -> ring
    # one-hot (LNp, EL) spread for admission writes (13 scalar-core
    # scatters per step otherwise)
    EL = max(len(entry), 1)
    E_el = np.zeros((LNp, EL), f32)
    for e, p in enumerate(entry):
        E_el[int(p), e] = 1.0
    tb["E_el"] = E_el
    tb.update(index_tables(tb, meta.type_ranges, G, I,
                           lane_shifts=(meta.inn_shifts, meta.out_shifts)))
    return tb, meta


def _onehot_index(E, name) -> np.ndarray:
    """(..., A, Bd) one-hot -> (..., A) int32 column index (-1: zero row).
    The einsum `E @ x` equals the gather `x[index]` only if every row holds
    at most one 1 and nothing else; anything else raises."""
    E = np.asarray(E)
    nz = E != 0
    cnt = nz.sum(-1)
    if (cnt > 1).any():
        raise ValueError(f"{name}: a one-hot row holds {int(cnt.max())} "
                         "ones; the einsum is not a gather")
    if not np.all(E[nz] == 1):
        raise ValueError(f"{name}: a one-hot entry is not 1")
    return np.where(cnt > 0, nz.argmax(-1), -1).astype(np.int32)


def _typed_flat(idx_t: np.ndarray, type_ranges, G: int,
                stride: int) -> np.ndarray:
    """(T, A) per-type source row -> (A * G,) flat index: output row
    a * G + g reads source row idx_t[type(g), a] * stride + g (-1: none)."""
    A = idx_t.shape[1]
    out = np.full((A, G), -1, np.int64)
    for t, (g0, g1) in enumerate(type_ranges):
        g = np.arange(g0, g1)[None, :]
        i = idx_t[t].astype(np.int64)[:, None]
        out[:, g0:g1] = np.where(i >= 0, i * stride + g, -1)
    return out.reshape(-1).astype(np.int32)


def _apply_shift_plan(rows: np.ndarray, n_out: int, shifts, gid, res_j,
                      res_src) -> np.ndarray:
    """The JAX ring step's _shifted_exchange on the host: masked static
    slices at the plan's offsets, then the residual gather."""
    lo = max(0, -min(shifts)) if shifts else 0
    hi = max(0, (max(shifts) if shifts else 0) + n_out - len(rows))
    rows_p = np.pad(rows, (lo, hi))
    out = np.zeros(n_out, rows.dtype)
    for k, o in enumerate(shifts):
        out = np.where(np.asarray(gid) == k, rows_p[o + lo:o + lo + n_out],
                       out)
    res_j = np.asarray(res_j)
    if res_j.shape[0]:
        out[np.clip(res_j, 0, n_out - 1)] = rows[np.clip(res_src, 0, None)]
    return out


def _lane_neighbour_src(tb, which, shifts) -> np.ndarray:
    """(LNp,) neighbour lane column (-1: none) of the JAX step's
    ring_lc._perm. Row p of _perm's output is lane ln_inner[p] /
    ln_outer[p] (0 where there is none); with the shift plan's offsets
    given, the plan applied to the lane index must reproduce that on every
    row, or the table is refused."""
    src = np.asarray(tb[f"ln_{which}"], np.int32)
    if shifts is not None:
        pre = "inn" if which == "inner" else "out"
        got = _apply_shift_plan(np.arange(len(src), dtype=np.int64),
                                len(src), tuple(shifts), tb[f"{pre}_gid"],
                                tb[f"{pre}_res_j"], tb[f"{pre}_res_src"])
        bad = (src >= 0) & (got != src)
        if bad.any():
            raise ValueError(f"ln_{which}: the shift plan disagrees with the "
                             f"neighbour column on {int(bad.sum())} rows")
    return src


def index_tables(tb: Dict[str, np.ndarray], type_ranges, G: int,
                 I: int, lane_shifts=None) -> Dict[str, np.ndarray]:
    """Gather indices for every one-hot operator of the ring step, built
    from the one-hot tables themselves (so they also apply to tables built
    by the JAX package). All int32, -1 meaning "none"; each `*_src` table
    indexes the row axis of the flattened (channels, rows, B) source.

      el_src     (LNp,)          E_el spread: entry lane feeding each lane
      start_src  (LPI*G,)        E_start: in-lane row (IL*G axis) of each
                                 link's start lane; also the one in-lane
                                 that can route its front into the link
                                 (to_link)
      end_src    (LPI*G,)        E_end after the (OL, I)[:, :G] lane view:
                                 lane row (LNp axis) of each link's end lane
      rl_src     (LPI*G,)        E_rl: roadlink row (MAXRL*G axis)
      out_src    (IL*KOUT*G,)    E_out: link row (LPI*G axis)
      app_src_g  (KIN, OL*G)     E_app per kin: link row (LPI*G axis)
      foe_src    (KC*LKp,)       foe_perm (or foe_gather): foe row of the
                                 (KC*LKp) notify-channel axis
      inner_src  (LNp,)          lane change: the inner / outer neighbour
      outer_src  (LNp,)          lane of each lane (ring_lc._perm);
                                 `lane_shifts` = (inn_shifts, out_shifts)
                                 checks the TPU shift plans against them
    """
    T = len(type_ranges)
    out: Dict[str, np.ndarray] = {}
    out["el_src"] = _onehot_index(tb["E_el"], "E_el")
    st = _onehot_index(tb["E_start"], "E_start")            # (T, LPI)
    real = st >= 0
    if not np.array_equal(st[real], np.asarray(tb["lk_start_il_t"])[real]):
        raise ValueError("E_start and lk_start_il_t disagree")
    out["start_src"] = _typed_flat(st, type_ranges, G, G)
    out["end_src"] = _typed_flat(_onehot_index(tb["E_end"], "E_end"),
                                 type_ranges, G, I)
    out["rl_src"] = _typed_flat(_onehot_index(tb["E_rl"], "E_rl"),
                                type_ranges, G, G)
    out["out_src"] = _typed_flat(_onehot_index(tb["E_out"], "E_out"),
                                 type_ranges, G, G)
    app = _onehot_index(tb["E_app"], "E_app")               # (T, KIN, OL)
    if not np.array_equal(app, np.transpose(np.asarray(tb["app_src"]),
                                            (0, 2, 1))):
        raise ValueError("E_app and app_src disagree")
    out["app_src_g"] = np.stack(
        [_typed_flat(app[:, kin], type_ranges, G, G)
         for kin in range(app.shape[1])]) if T else \
        np.zeros((app.shape[1], 0), np.int32)
    if "foe_perm" in tb:
        out["foe_src"] = _typed_flat(
            _onehot_index(tb["foe_perm"], "foe_perm"), type_ranges, G, G)
    else:
        out["foe_src"] = np.asarray(tb["foe_gather"], np.int32).reshape(-1)
    inn, outr = lane_shifts if lane_shifts is not None else (None, None)
    out["inner_src"] = _lane_neighbour_src(tb, "inner", inn)
    out["outer_src"] = _lane_neighbour_src(tb, "outer", outr)
    return out
