"""K3 car_follow and K2 cross_caps: the plain versions against numpy walks
written here, on the seeded edge cases of
cityflow_tpu_torch/tools/kernel_cases.py (the cases chip_smoke.py holds the
CUDA kernels to, bit for bit, on the card).

The walks restate the reference's formulas in float32, one operation at a
time in the reference's order: getIntersectionRelatedSpeed and
getNextSpeed's min-rule (vehicle.cpp:200-376: no_collision_speed,
getStopBeforeSpeed, getReachSteps, canYield) and Cross::canPass
(roadnet.cpp:604-660). Their inputs are built as the reference reads them:
each element's leader in the ring-leader mode is the slot in front of it
(walked slot by slot; a link row's slot 0 follows the end-lane tail), the
lane fronts take the approach rows' result where that row is relevant, a
template index outside [0, TP) reads zeros, a cross's foe is read through
foe_src, and a cross's failure walks the crosses in order.

Values are compared as bits (+0.0 and -0.0 apart), with two stated
exceptions: the plain version runs with numpy's square root in place of
PyTorch's (its CPU float32 sqrt is not correctly rounded on about 0.6% of
inputs; numpy's, the card's and the reference's are), and a NaN matches a
NaN whatever its payload (x86 gives a NaN the payload of whichever operand
the compiled loop puts first, which differs between numpy and PyTorch).
"""

import numpy as np
import pytest
import torch

from cityflow_tpu_torch.core import step as step_mod
from cityflow_tpu_torch.kernels import car_follow, cross_caps
from cityflow_tpu_torch.tools import kernel_cases as kc

F = np.float32
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
# template table columns (compiler/net.py P_*)
P_LEN, P_MAXPOSACC, P_MAXNEGACC, P_USUALPOSACC, P_USUALNEGACC, P_MINGAP, \
    P_MAXSPEED, P_HEADWAY, P_YIELD, P_TURNSPEED = 1, 3, 4, 5, 6, 7, 8, 9, 10, \
    11


@pytest.fixture
def ieee_sqrt(monkeypatch):
    """The plain versions with numpy's correctly rounded float32 sqrt."""
    orig = step_mod._sqrt

    def sqrt(x):
        if x.device.type == "cpu" and x.dtype == torch.float32:
            return torch.from_numpy(np.sqrt(x.numpy()))
        return orig(x)
    monkeypatch.setattr(step_mod, "_sqrt", sqrt)


def _sat(v):
    """XLA's float32 -> int32: saturate, NaN -> 0, truncate."""
    v = np.asarray(v, F).astype(np.float64)
    out = np.where(np.isnan(v), 0.0, np.trunc(np.nan_to_num(v)))
    out = np.where(v >= 2.0 ** 31, I32_MAX, np.where(v < -2.0 ** 31, I32_MIN,
                                                     out))
    return out.astype(np.int64).astype(np.int32)


def _param(table, idx, col):
    """Column `col` of each index's template row; zeros outside [0, TP)."""
    idx = np.asarray(idx)
    ok = (idx >= 0) & (idx < table.shape[0])
    return np.where(ok, table[np.where(ok, idx, 0), col], F(0))


def _bits_equal(got, want):
    """Floats bit for bit, a NaN against any NaN; others exactly."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype == np.float32:
        same = (got.view(np.int32) == want.view(np.int32)) \
            | (np.isnan(got) & np.isnan(want))
    else:
        same = got == want
    return int((~same).sum())


# ---- the reference's formulas, float32 -------------------------------------

def _ncs(vL, dL, vF, dF, gap, dt, tg):
    """no_collision_speed, vehicle.cpp:200-209."""
    c = vF * dt / F(2) + tg - F(0.5) * vL * vL / dL - gap
    a = F(0.5) / dF
    b = F(0.5) * dt
    disc = b * b - F(4) * a * c
    v1 = F(0.5) / a * (np.sqrt(np.maximum(disc, F(0))) - b)
    v2 = F(2) * vL - dL * dt + F(2) * (gap - tg) / dt
    v = np.minimum(v1, v2)
    return np.where(b * b < F(4) * a * c, F(-100), v)


def _stop_before(speed, upa, una, distance, dt):
    """getStopBeforeSpeed, vehicle.cpp:240-250 (brakeDistanceAfterAccel
    :302-306); (int)takeInterval truncates, x86 gives INT_MIN out of
    range."""
    nxt = speed + upa * dt
    bda = (speed + nxt) * dt / F(2) + (nxt * nxt / una / F(2))
    ti = F(2) * distance / (speed + F(1e-8)) / dt
    ti_int = np.where(np.abs(ti) >= F(2.0 ** 31), F(-2.0 ** 31), np.trunc(ti))
    slow = np.where(ti >= F(1), speed - speed / ti_int, speed - speed / ti)
    return np.where(bda < distance, speed + upa * dt, slow)


def _ref_min(a, b):
    """std::min(a, b): b < a ? b : a."""
    return np.where(b < a, b, a)


def _reach_steps(speed, distance, target, acc, dt):
    """getReachSteps, vehicle.cpp:252-268 (getDistanceUntilSpeed :275-282),
    int32 with the saturating cast."""
    r_fast = np.ceil(distance / np.where(speed > F(0), speed, F(1)))
    s1 = np.floor((target - speed) / acc / dt)
    v1 = speed + s1 * acc / dt
    d1 = (speed + v1) * (s1 * dt) / F(2)
    dts = d1 + np.where(v1 < target, (v1 + target) * dt / F(2), F(0))
    dts = np.where(target <= speed, F(0), dts)
    r_a = np.ceil((np.sqrt(np.maximum(speed * speed + F(2) * acc * distance,
                                      F(0))) - speed) / acc / dt)
    r_b = (np.ceil((target - speed) / acc / dt)
           + np.ceil((distance - dts) / target / dt))
    r = np.where(speed > target, r_fast, np.where(dts > distance, r_a, r_b))
    return _sat(np.where(distance <= F(0), F(0), r))


# ---- K3 --------------------------------------------------------------------

def _k3_inputs(case):
    """Every input at the call's full shape, numpy; the ring-leader mode's
    leader views walked slot by slot; the subject's and the leader's
    parameters per element."""
    shape = case["shape"]
    r = case["ring"]
    full = lambda v: np.broadcast_to(np.asarray(
        r[v[1:]].reshape(shape) if isinstance(v, str) else v), shape)
    g = {k: full(v) for k, v in case["inp"].items()}
    names = ("maxspd", "turnspd", "upa", "una", "yld", "maxneg", "mingap",
             "headway", "maxpos")
    cols = (P_MAXSPEED, P_TURNSPEED, P_USUALPOSACC, P_USUALNEGACC, P_YIELD,
            P_MAXNEGACC, P_MINGAP, P_HEADWAY, P_MAXPOSACC)
    dt = F(case["prm"][9])
    table = case["table"]
    if table is None:
        p = {n: np.full(shape, F(v)) for n, v in zip(names, case["prm"])}
    else:
        tpl = full(case["tpl"])
        p = {n: _param(table, tpl, c) for n, c in zip(names, cols)}
    lead_p = lambda t: (_param(table, t, P_MAXNEGACC),
                        _param(table, t, P_USUALNEGACC))
    if r is not None:
        S, N, B = r["dis"].shape
        dis, spd, n_occ = r["dis"], r["speed"], r["n"]
        lead_dis = np.empty((S, N, B), F)
        lead_spd = np.empty((S, N, B), F)
        has = np.empty((S, N, B), bool)
        lead_tpl = np.zeros((S, N, B), np.int32)
        for s in range(S):
            if s == 0:
                lead_dis[0], lead_spd[0], has[0] = F(1e9), F(0), False
                if r["kind"] == "link":
                    lead_spd[0] = r["s0"][2]
                    has[0] = r["s0"][5] > F(0.5)
                    if table is not None:
                        lead_tpl[0] = _sat(r["s0"][6])
            else:
                lead_dis[s], lead_spd[s] = dis[s - 1], spd[s - 1]
                has[s] = s - 1 < n_occ
                if table is not None:
                    lead_tpl[s] = r["tpl"][s - 1]
        lead_len = (F(r["lead_len"]) if table is None
                    else _param(table, lead_tpl, P_LEN))
        gap = (lead_dis - lead_len) - dis
        if r["kind"] == "link":
            ll0 = lead_len if table is None else lead_len[0]
            gap[0] = np.where(has[0], ((r["len_row"][:, None] - dis[0])
                                       + r["s0"][0]) - ll0, gap[0])
        else:
            occ = np.arange(S)[:, None, None] < n_occ[None]
            g["lane_left"] = (r["len_row"][:, None] - dis).reshape(shape)
            g["invalid"] = (occ & (r["nxt"] < 0) & ~r["last"]).reshape(shape)
        g.update(gap=gap.reshape(shape), lead_spd=lead_spd.reshape(shape),
                 has_lead=has.reshape(shape))
        lead = lead_tpl.reshape(shape)
    else:
        lead = case["lead_tpl"]
    if table is None:
        p["l_maxneg"], p["l_una"] = p["maxneg"], p["una"]
    elif case["mode"] & 2:
        p["l_maxneg"], p["l_una"] = lead_p(lead)
    return g, p, dt


def walk_follow(case):
    """K3's outputs: (v_isr, red_stop), v (raw), (v, delta) or, in the
    ring-leader mode, (v, delta, new distance)."""
    with np.errstate(all="ignore"):
        g, p, dt = _k3_inputs(case)
    mode, shape = case["mode"], case["shape"]
    with np.errstate(all="ignore"):
        speed = g["speed"]
        if mode & 1:
            # getIntersectionRelatedSpeed (vehicle.cpp:308-345)
            v_isr = np.broadcast_to(p["maxspd"], shape)
            app = g["app"]
            v_isr = np.where(app & g["turn"],
                             np.minimum(v_isr, p["turnspd"]), v_isr)
            v_stop = _stop_before(speed, p["upa"], p["una"],
                                  g["ff_d"] - g["dls"] - p["yld"], dt)
            v_isr = np.where(g["any_fail"], _ref_min(v_isr, v_stop), v_isr)
            red = app & (~g["avail"] | ~g["can_enter"])
            min_brake = F(0.5) * speed * speed / p["maxneg"]
            red_stop = red & ~(min_brake > g["isr_lane_left"])
            v_red = _ref_min(p["maxspd"], _stop_before(
                speed, p["upa"], p["una"], g["isr_lane_left"], dt))
            v_isr = np.where(red_stop, v_red, v_isr)
            if mode == 1:
                return v_isr.astype(F), np.broadcast_to(red_stop, shape)
        else:
            v_isr = g["v_isr"]
        # getNextSpeed's min-rule (vehicle.cpp:346-376)
        lead_spd, gap = g["lead_spd"], g["gap"]
        custom = g["custom"]
        v_hard = _ncs(lead_spd, p["l_maxneg"], speed, p["maxneg"], gap, dt,
                      F(0))
        assume_decel = np.where(speed > lead_spd, speed - lead_spd, F(0))
        v_soft = _ncs(lead_spd, p["l_una"], speed, p["una"], gap, dt,
                      p["mingap"])
        v_headway = ((gap + (lead_spd + assume_decel / F(2)) * dt
                      - speed * dt / F(2)) / (p["headway"] + dt / F(2)))
        v_plain = np.minimum(np.minimum(v_hard, v_soft), v_headway)
        v_lead = np.where(g["has_custom"], np.minimum(custom, v_hard),
                          v_plain)
        v_nolead = np.where(g["has_custom"], custom, p["maxspd"])
        v_cf = np.where(g["has_lead"], v_lead, v_nolead)
        v = np.minimum(p["maxspd"], speed + p["maxpos"] * dt)
        v = np.minimum(v, g["drv_maxspd"])
        v = np.minimum(v, v_cf)
        v = np.where(g["isr_rel"], np.minimum(v, v_isr), v)
        if "v_yield" in g:
            v = np.minimum(v, g["v_yield"])
        v_inv = _ncs(F(0), F(1), speed, p["maxneg"], g["lane_left"], dt,
                     p["mingap"])
        v = np.where(g["invalid"], np.minimum(v, v_inv), v)
        v = np.maximum(v, speed - p["maxneg"] * dt).astype(F)
        neg = v < F(0)
        delta = np.where(neg, F(0.5) * speed * speed / p["maxneg"],
                         (speed + v) * dt / F(2)).astype(F)
        out_v = v if case["raw"] else np.where(neg, F(0), v).astype(F)
    r = case["ring"]
    if r is None:
        return out_v if case["raw"] else (out_v, delta)
    with np.errstate(all="ignore"):
        ndis = (r["dis"].reshape(shape) + delta).astype(F)
    if r["kind"] == "lane":
        # a lane front whose in-lane's approach row is relevant takes its
        # result
        S, N, B = r["dis"].shape
        out_v = out_v.reshape(S, N, B).copy()
        ndis = ndis.reshape(S, N, B)
        for a in range(r["ap_v"].shape[0]):
            for lane in range(N):
                i = r["in_inv"][lane]
                if i < 0:
                    continue
                use = r["ap_rel"][a, i]
                out_v[a, lane] = np.where(use, r["ap_v"][a, i],
                                          out_v[a, lane])
                if not case["raw"]:
                    ndis[a, lane] = np.where(use, r["ap_d"][a, i],
                                             ndis[a, lane])
        out_v, ndis = out_v.reshape(shape), ndis.reshape(shape)
    return out_v if case["raw"] else (out_v, delta, ndis)


@pytest.mark.parametrize("name", kc.FOLLOW_CASES)
def test_car_follow_plain_matches_the_walk(name, ieee_sqrt):
    case = kc.follow_case(name)
    a, k = kc.follow_args(case, "cpu")
    got = car_follow.car_follow_plain(*a, **k)
    want = walk_follow(case)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (gt, w) in enumerate(zip(got, want)):
        bad = _bits_equal(gt.numpy(), np.ascontiguousarray(w))
        assert bad == 0, f"{name}: output {i}: {bad} values differ"
    # the wrapper takes the plain version on CPU tensors
    again = car_follow.car_follow(*a, **k)
    again = again if isinstance(again, tuple) else (again,)
    for gt, ag in zip(got, again):
        assert torch.equal(gt.view(torch.int32) if gt.dtype == torch.float32
                           else gt, ag.view(torch.int32)
                           if ag.dtype == torch.float32 else ag)


def test_follow_cases_reach_their_edges():
    """The seeded cases hold what their names promise: rows with n = 0
    and n = S, link slot 0 with and without a tail, fronts without an
    in-lane or a relevant approach row, out-of-range and above-TPS
    template indices, stopped vehicles at the line, NaN and inf."""
    seen = set()
    for name, case in kc.follow_cases():
        r = case["ring"]
        if r is not None:
            S = r["dis"].shape[0]
            seen |= {"n0"} if (r["n"] == 0).any() else set()
            seen |= {"nS"} if (r["n"] == S).any() else set()
            if r["kind"] == "link":
                ex = r["s0"][5] > 0.5
                seen |= {"tail"} if ex.any() else set()
                seen |= {"no_tail"} if (~ex).any() else set()
            else:
                seen |= {"no_in_lane"} if (r["in_inv"] < 0).any() else set()
                seen |= {"ap_off"} if (~r["ap_rel"]).any() else set()
        if case["table"] is not None:
            TP = case["table"].shape[0]
            t = r["tpl"] if isinstance(case["tpl"], str) else case["tpl"]
            seen |= {"tpl_out"} if ((t < 0) | (t >= TP)).any() else set()
            seen |= {"tpl_above_64"} if (t >= 64).any() else set()
        isr = case["inp"].get("isr_lane_left")
        if isinstance(isr, np.ndarray):
            stop = (case["inp"]["speed"] == 0) & (isr == 0)
            seen |= {"stopped"} if stop.any() else set()
        flt = [v for v in case["inp"].values()
               if isinstance(v, np.ndarray) and v.dtype == F]
        seen |= {"nan"} if any(np.isnan(v).any() for v in flt) else set()
        seen |= {"inf"} if any(np.isinf(v).any() for v in flt) else set()
        B = case["shape"][-1]
        seen.add(f"B{B}")
        seen |= {"offset"} if case["offset"] else set()
    assert seen >= {"n0", "nS", "tail", "no_tail", "no_in_lane", "ap_off",
                    "tpl_out", "tpl_above_64", "stopped", "nan", "inf",
                    "B1", "B3", "B128", "B130", "offset"}, seen


def test_car_follow_views_by_strides():
    """The kernel's view of an input: its strides over the call's four
    dimensions, 0 where it broadcasts; any broadcastable tensor, a
    scalar as a value, and a refusal for one that does not broadcast."""
    shape = (7, 4, 5, 8)
    assert car_follow._dims((12, 9, 8)) == (12, 1, 9, 8)
    assert car_follow._dims(shape) == shape
    v = car_follow._view(torch.zeros(4, 5, 1), shape, "turn")
    assert tuple(v.st) == (0, 5, 1, 0) and v.p is not None
    v = car_follow._view(torch.zeros(9, 1), (12, 9, 8), "drv_maxspd")
    assert tuple(v.st) == (0, 0, 1, 0)
    v = car_follow._view(torch.zeros(4, 1, 8, dtype=torch.bool), shape,
                         "x")
    assert tuple(v.st) == (0, 8, 0, 1) and v.is_bool == 1
    v = car_follow._view(2.5, shape, "x")
    assert v.p is None and v.val == 2.5
    with pytest.raises(ValueError):
        car_follow._view(torch.zeros(3, 5, 8), shape, "x")
    with pytest.raises(ValueError):
        car_follow._dims((1, 2, 3, 4, 5))


# ---- K2 --------------------------------------------------------------------

def walk_caps(case):
    """Cross::canPass (roadnet.cpp:604-660) for every (row, link, env),
    the link's crosses walked in order: (any_fail, first fail's distance,
    its foe lpi, the largest among equal distances)."""
    dls, speed, rel = case["dls"], case["speed"], case["rel"]
    R, LK, B = dls.shape
    tb = case["tabs"]
    KC = tb["d"].shape[0]
    maxneg, yld, ln, turnspd, maxspd, upa, dt = (F(v) for v in case["prm"])
    if case["table"] is not None:
        t, table = case["tpl"], case["table"]
        maxneg, yld, ln, turnspd, maxspd, upa = (
            _param(table, t, c) for c in (P_MAXNEGACC, P_YIELD, P_LEN,
                                          P_TURNSPEED, P_MAXSPEED,
                                          P_USUALPOSACC))
    target = np.where(tb["turn"][None, :, None], turnspd, maxspd)
    ent = np.broadcast_to(F(case["ent"]), dls.shape)
    any_fail = np.zeros((R, LK, B), bool)
    ff_d = np.full((R, LK, B), np.inf, F)
    ff_foe = np.full((R, LK, B), -1, np.int32)
    fields = case["fields"]
    with np.errstate(all="ignore"):
        for kc_ in range(KC):
            d = tb["d"][kc_][None, :, None]
            src = case["foe_src"].reshape(KC, LK)[kc_]
            foe = np.where((src >= 0)[None, :, None],
                           fields[:, np.maximum(src, 0)], F(0))[:, None]
            exists, f_yield, cleared, cyc = (foe[i] > F(0.5)
                                             for i in range(4))
            fr, fdist, fent, fph, fplo = (foe[i] for i in range(4, 9))
            d1 = d - dls
            # canYield (vehicle.cpp:284-287)
            min_brake = F(0.5) * speed * speed / maxneg
            self_yield = ((d1 > F(0)) & (min_brake < d1 - yld)) \
                | ((d1 < F(0)) & (d1 + ln < F(0)))
            sr = np.minimum(_reach_steps(speed, d1, target, upa, dt),
                            255).astype(F)
            pri_win = (case["ph"] > fph) | ((case["ph"] == fph)
                                            & (case["plo"] > fplo))
            same_rank = np.where(
                fr > sr, -1, np.where(
                    fr < sr, 1, np.where(
                        ent == fent,
                        np.where(d1 == fdist, np.where(pri_win, -1, 1),
                                 np.where(d1 < fdist, -1, 1)),
                        np.where(ent < fent, -1, 1))))
            dpos = fdist > F(0)
            t_eq = np.where(dpos, same_rank, np.where(cleared, -1, 1))
            t_lt = np.where(dpos, np.where(fr > sr, -1, 1),
                            np.where(cleared, -1, 1))
            t1 = tb["t1"][None, :, None]
            t2 = tb["t2"][kc_][None, :, None]
            y = np.where(t1 > t2, -1, np.where(t1 < t2, t_lt, t_eq))
            y = np.where(~f_yield, 1, y)
            y = np.where((y == 1) & cyc, -1, y)
            passes = ~exists | ~self_yield | (y == -1)
            considered = tb["cvalid"][kc_][None, :, None] & (d >= dls) & rel
            fail = considered & ~passes
            any_fail |= fail
            fl = tb["foelpi"][kc_][None, :, None]
            first = fail & (d < ff_d)
            tie = fail & (d == ff_d) & (fl > ff_foe)
            ff_foe = np.where(first | tie, fl, ff_foe).astype(np.int32)
            ff_d = np.where(first, d, ff_d).astype(F)
    return any_fail, ff_d, ff_foe


@pytest.mark.parametrize("name", kc.CAPS_CASES)
def test_cross_caps_plain_matches_the_walk(name, ieee_sqrt):
    case = kc.caps_case(name)
    a, k = kc.caps_args(case, "cpu")
    got = cross_caps.cross_caps_plain(*a, **k)
    for i, (gt, w) in enumerate(zip(got, walk_caps(case), strict=True)):
        bad = _bits_equal(gt.numpy(), w)
        assert bad == 0, f"{name}: output {i}: {bad} values differ"
    again = cross_caps.cross_caps(*a, **k)
    for gt, ag in zip(got, again):
        assert torch.equal(gt, ag)


def test_caps_cases_reach_their_edges():
    """Every case has considered crosses that fail and pass, crosses
    without a foe, ties in distance among failing crosses, rows whose
    reach ties their foe's, and some case reaches 255 and above."""
    seen = set()
    for name, case in kc.caps_cases():
        tb = case["tabs"]
        d = tb["d"]
        seen |= {"no_foe"} if (case["foe_src"] < 0).any() else set()
        seen |= {"tied_d"} if (np.diff(d, axis=0) == 0).any() else set()
        seen |= {"irrelevant"} if (~case["rel"]).any() else set()
        seen |= {"R%d" % case["dls"].shape[0], "KC%d" % d.shape[0]}
        seen |= {"B%d" % case["dls"].shape[2]}
        seen |= {"tpl"} if case["table"] is not None else set()
        seen |= {"app"} if not isinstance(case["ent"], np.ndarray) else set()
        _, ff_d, _ = walk_caps(case)
        seen |= {"fails"} if np.isfinite(ff_d).any() else set()
        with np.errstate(all="ignore"):
            rs = _reach_steps(case["speed"][:, None], d[None, :, :, None]
                              - case["dls"][:, None], F(case["prm"][4]),
                              F(case["prm"][5]), F(case["prm"][6]))
        seen |= {"reach255"} if (rs >= 255).any() else set()
    assert seen >= {"no_foe", "tied_d", "irrelevant", "R1", "R2", "R3",
                    "R4", "KC1", "KC20", "B1", "B3", "B33", "B128", "B130",
                    "tpl", "app", "fails", "reach255"}, seen


def test_car_follow_refuses_32_bit_overflow():
    """K3 indexes in 32 bits: the CUDA branch refuses a call of 2^31
    elements or more, and one of more than 4 dims, before any tensor is
    read (`_dims`, which it calls first); the CPU branch is the plain
    version and takes both."""
    with pytest.raises(ValueError, match="32 bits"):
        car_follow._dims((2, 2 ** 16, 2 ** 15, 1))
    with pytest.raises(ValueError, match="expected 1 to 4"):
        car_follow._dims((1, 1, 1, 1, 1))
    assert car_follow._dims((3, 5, 2)) == (3, 1, 5, 2)
    v, delta = car_follow.car_follow(
        2, kc.FOLLOW_PRM, (2, 1, 1, 3, 1), speed=torch.ones(2, 1, 1, 3, 1),
        gap=0.0, lead_spd=0.0, has_lead=False, v_isr=0.0, isr_rel=False,
        custom=0.0, has_custom=False, drv_maxspd=0.0, invalid=False,
        lane_left=0.0)
    assert v.shape == delta.shape == (2, 1, 1, 3, 1)
