"""G4 cross_pass: the plain version against a numpy walk of the reference's
rule, on the seeded edge cases of cityflow_tpu_torch/tools/kernel_cases.py
(the cases chip_smoke.py holds the CUDA kernel to on the card, bit for
bit).

The walk restates Vehicle::getIntersectionRelatedSpeed's cross loop
(vehicle.cpp:357-374) vehicle by vehicle, with Python loops: the turn cap,
then the lanelink's crosses in distance order, skipping the invalid ones
and those behind the vehicle, each asked Cross::canPass
(roadnet.cpp:604-660) in the reference's order of questions: no foe
passes; a vehicle that cannot yield passes; a foe that cannot yield makes
it yield; else by road-link type, the foe's reach steps where it is past
the cross (or whether it has cleared it), enter time, distance and
priority; a yield is flipped to a pass by a blocker cycle from the foe.
The first cross it does not pass caps its speed at the stop speed before
it and names its notifier as the blocker where the vehicle may block. The
foe's terms are G3's own-side tables read through lnk_cross_foe_pos.
"""

import numpy as np
import pytest

from cityflow_tpu_torch.kernels import cross_pass
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_follow_cases import (  # noqa: F401 (ieee_sqrt: a fixture)
    _bits_equal, ieee_sqrt)

P_LEN, P_MAXNEGACC, P_USUALPOSACC, P_USUALNEGACC, P_MAXSPEED, P_YIELD, \
    P_TURNSPEED = 1, 4, 5, 6, 8, 10, 11


def _sat(x):
    """XLA's float -> int32: saturate, NaN -> 0, truncate."""
    if np.isnan(x):
        return 0
    if x >= 2.0 ** 31:
        return 2 ** 31 - 1
    if x < -2.0 ** 31:
        return -2 ** 31
    return int(np.trunc(x))


def _reach(speed, d, target, acc, dt):
    """getReachSteps (vehicle.cpp:252-268, getDistanceUntilSpeed
    :275-282) in the case's float type."""
    F = type(speed)
    if d <= F(0):
        return 0
    if speed > target:
        return _sat(np.ceil(d / (speed if speed > F(0) else F(1))))
    s1 = np.floor((target - speed) / acc / dt)
    v1 = speed + s1 * acc / dt
    dts = (speed + v1) * (s1 * dt) / F(2)
    if v1 < target:
        dts = dts + (v1 + target) * dt / F(2)
    if target <= speed:
        dts = F(0)
    if dts > d:
        return _sat(np.ceil((np.sqrt(max(speed * speed + F(2) * acc * d,
                                         F(0))) - speed) / acc / dt))
    return _sat(np.ceil((target - speed) / acc / dt)
                + np.ceil((d - dts) / target / dt))


def _stop_before(speed, upa, una, distance, dt):
    """getStopBeforeSpeed (vehicle.cpp:240-250)."""
    F = type(speed)
    nxt = speed + upa * dt
    bda = (speed + nxt) * dt / F(2) + (nxt * nxt / una / F(2))
    if bda < distance:
        return speed + upa * dt
    ti = F(2) * distance / (speed + F(1e-8)) / dt
    if ti >= F(1):
        ti_int = F(-2.0 ** 31) if abs(ti) >= F(2.0 ** 31) else np.trunc(ti)
        return speed - speed / ti_int
    return speed - speed / ti


def _can_yield(speed, max_neg, yld, length, d):
    """Vehicle::canYield (vehicle.cpp:284-287)."""
    F = type(speed)
    return ((d > F(0) and F(0.5) * speed * speed / max_neg < d - yld)
            or (d < F(0) and d + length < F(0)))


def _can_pass(c, b, v, r, k, d1, t1, target, ev):
    """Cross::canPass of vehicle v (env b) at cross k of lanelink r; `ev`
    collects the branches taken."""
    p = c["params"][b, v]
    speed, dt = c["speed"][b, v], c["net"]["interval"][()]
    fp = c["net"]["lnk_cross_foe_pos"][r, k]
    o = {key: a[b].reshape(-1)[fp] for key, a in c["own"].items()}
    if not o["exists"]:
        ev.add("no_foe")
        return True
    if not _can_yield(speed, p[P_MAXNEGACC], p[P_YIELD], p[P_LEN], d1):
        ev.add("no_self_yield")
        return True
    t2 = c["net"]["lnk_cross_foetype"][r, k]
    if not o["yield"]:
        y = 1
        ev.add("foe_cannot_yield")
    elif t1 > t2:
        y = -1
        ev.add("t1>t2")
    else:
        ev.add("t1<t2" if t1 < t2 else "t1=t2")
        ev.add(f"dpos{int(o['dpos'])}_cleared{int(o['cleared'])}")
        if o["dpos"]:
            fr = o["reach"]
            sr = _reach(speed, d1, target, p[P_USUALPOSACC], dt)
            ev.add("reach")
            if fr > sr:
                y = -1
            elif fr < sr or t1 < t2:
                y = 1
            else:
                me = c["ent"][b, v]
                if me != o["ent"]:
                    y = -1 if me < o["ent"] else 1
                    ev.add("tie_ent")
                elif d1 == o["dist"]:
                    y = -1 if c["pri"][b, v] > o["pri"] else 1
                    ev.add("tie_pri")
                else:
                    y = -1 if d1 < o["dist"] else 1
                    ev.add("tie_dist")
        else:
            y = -1 if o["cleared"] else 1
    if y == 1 and o["cyc"]:
        ev.add("cycle")
        y = -1
    return y == -1


def walk(c):
    """(v_isr, any_fail, ff_d, new_blocker, events): events per vehicle,
    a set of the branches its crosses took and where it failed."""
    B, V = c["the_ll"].shape
    net = c["net"]
    cd, LL = net["lnk_cross_d"], net["lnk_cross_d"].shape[0]
    KC = cd.shape[1]
    out = dict(v_isr=np.zeros((B, V), c["dls"].dtype),
               any_fail=np.zeros((B, V), bool),
               ff_d=np.zeros((B, V), c["dls"].dtype),
               new_blocker=np.full((B, V), -1, np.int32))
    events = {}
    for b in range(B):
        for v in range(V):
            p = c["params"][b, v]
            speed, dls = c["speed"][b, v], c["dls"][b, v]
            v_isr = p[P_MAXSPEED]
            if c["next_turn"][b, v]:
                # torch.minimum: a NaN propagates, a tie keeps the first
                t = p[P_TURNSPEED]
                v_isr = v_isr if np.isnan(v_isr) else (
                    t if np.isnan(t) or t < v_isr else v_isr)
            ll = c["the_ll"][b, v]
            r = min(max(ll, 0), LL - 1)
            ev = set() if ll >= 0 else {"no_lanelink"}
            first = -1
            if ll >= 0:
                t1 = net["ll_type"][r]
                target = p[P_TURNSPEED] if net["ll_is_turn"][r] \
                    else p[P_MAXSPEED]
                for k in range(KC):
                    if not net["lnk_cross_valid"][r, k]:
                        ev.add("invalid")
                        continue
                    if not cd[r, k] >= dls:
                        ev.add("behind")
                        continue
                    if not _can_pass(c, b, v, r, k, cd[r, k] - dls, t1,
                                     target, ev):
                        first = k
                        break
            if np.isnan(dls):
                ev.add("nan_dls")
            if np.isnan(speed):
                ev.add("nan_speed")
            if dls == 0 and np.signbit(dls):
                ev.add("neg0_dls")
            if speed == 0 and np.signbit(speed):
                ev.add("neg0_speed")
            ffd = cd[r, max(first, 0)]
            if first >= 0:
                ev.add("fail_first" if first == 0 else "fail_later")
                if first == KC - 1:
                    ev.add("fail_last")
                stop = _stop_before(speed, p[P_USUALPOSACC],
                                    p[P_USUALNEGACC], ffd - dls - p[P_YIELD],
                                    net["interval"][()])
                v_isr = stop if stop < v_isr else v_isr
                if c["blk_ok"][b, v]:
                    fp = net["lnk_cross_foe_pos"][r, first]
                    out["new_blocker"][b, v] = c["own"]["idx"][b].reshape(
                        -1)[fp]
                else:
                    ev.add("fail_no_blocker")
            elif ll >= 0:
                ev.add("no_failure")
            out["v_isr"][b, v], out["ff_d"][b, v] = v_isr, ffd
            out["any_fail"][b, v] = first >= 0
            events[(b, v)] = ev
    return out, events


@pytest.mark.parametrize("name", kc.CROSS_CASES)
def test_cross_plain_matches_reference_walk(name, ieee_sqrt):
    case = kc.cross_case(name)
    got = cross_pass.cross_pass(*kc.cross_args(case, "cpu"))
    want, _ = walk(case)
    for key, g in zip(("v_isr", "any_fail", "ff_d", "new_blocker"), got):
        assert _bits_equal(g.numpy(), want[key]) == 0, (name, key)


CRAFTED = {                     # crafted slot -> the branches it must take
    0: {"no_lanelink"},
    1: {"fail_last", "no_foe"},
    2: {"fail_first", "fail_no_blocker", "foe_cannot_yield"},
    3: {"no_failure", "cycle", "foe_cannot_yield"},
    4: {"tie_ent", "no_failure"}, 5: {"tie_ent", "fail_first"},
    6: {"tie_dist", "no_failure"}, 7: {"tie_dist", "fail_first"},
    8: {"tie_pri", "no_failure"}, 9: {"tie_pri", "fail_first"},
    10: {"t1>t2", "t1<t2", "dpos0_cleared1", "dpos0_cleared0", "cycle",
         "t1=t2"},
    11: {"t1<t2", "reach", "cycle", "fail_later"},
    12: {"behind", "invalid", "fail_later"},
    13: {"nan_dls", "behind", "no_failure"},
    14: {"neg0_dls", "neg0_speed", "no_self_yield", "fail_later"},
    15: {"nan_speed", "no_self_yield", "no_failure"},
}


def test_cross_cases_reach_their_edges():
    """Each case's crafted vehicles take the branches they were made for
    (in every env; with KC = 1 only the first cross of each is kept); the
    set of cases covers B = 1, 3, 128 and 130, both float types, KC = 1
    and KC above 16, every branch of the decision, the
    four dpos / cleared combinations and NaN / -0.0 in dls and speed."""
    seen = {"B": set(), "fp": set(), "KC": set()}
    union = set()
    for name, c in kc.cross_cases():
        B, V = c["the_ll"].shape
        KC = c["net"]["lnk_cross_d"].shape[1]
        seen["B"].add(B)
        seen["fp"].add(c["dls"].dtype)
        seen["KC"].add(KC)
        # the walk is slow in Python: the crafted slots of the first and
        # last env, and every vehicle of the smaller cases
        if B * V > 5000:
            c = dict(c, **{k: c[k][[0, -1]] for k in (
                "the_ll", "dls", "speed", "params", "ent", "pri",
                "next_turn", "blk_ok")}, own={k: a[[0, -1]] for k, a in
                                             c["own"].items()})
        _, ev = walk(c)
        for s in set().union(*ev.values()):
            union.add(s)
        if KC < 4:
            continue
        for (b, v), e in ev.items():
            if v in CRAFTED:
                assert CRAFTED[v] <= e, (name, b, v, CRAFTED[v] - e)
    assert seen["B"] == {1, 3, 128, 130}
    assert seen["fp"] == {np.dtype(np.float32), np.dtype(np.float64)}
    assert 1 in seen["KC"] and max(seen["KC"]) > 16
    want = set().union(*CRAFTED.values()) | {
        "dpos1_cleared0", "dpos1_cleared1", "fail_first", "fail_later"}
    assert want <= union, want - union


def test_cross_pass_refuses_offsets_past_32_bits():
    """The kernel indexes with 32-bit offsets: the wrapper refuses a call
    whose B * V * NP or B * LL * KC reaches 2^31, on the CPU too
    (offsets_fit, which it calls before either branch), and takes the
    largest path's shapes."""
    with pytest.raises(ValueError, match="32-bit"):
        cross_pass.offsets_fit(128, 2 ** 21, 12, 100, 8)
    with pytest.raises(ValueError, match="32-bit"):
        cross_pass.offsets_fit(128, 1000, 12, 2 ** 21, 8)
    cross_pass.offsets_fit(128, 131072, 12, 30000, 16)
