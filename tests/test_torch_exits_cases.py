"""R2 ring_exits, its exits stage: the plain version against a numpy walk
of the reference rule, on the seeded edge cases of
cityflow_tpu_torch/tools/kernel_cases.py (the cases chip_smoke.py holds
the CUDA kernel to on the card, bit for bit), and the stage's in-place
write of the new distances.

The walk restates the JAX commit's regions (cityflow_tpu/core/ring.py
:1462-1483, :1530-1566, :1908-1929) slot by slot with Python loops. Per
(lane, env): a vehicle in an occupied slot (s < n_l) with no next hop
that is not at its route's end (invalid) has its new distance clamped to
the lane's length (min, NaN kept); a slot crosses when it is occupied and
its distance is past the lane's end; the slots s < XK that cross in an
unbroken run from the front leave (x_l of them); of those, a vehicle at
its route's end (or, under lane change, a shadow) is removed (its travel
time now - enter summed per env) and one with a next hop exits into a
link; a slot >= XK that crosses sets OV_HOPS. Under lane change the leave
flags span all SL slots and chanA / chanB flag the leavers into a link /
at their route's end. Links: the same prefix; the committed blocker is
the foe of the front-most occupied failing slot, else the approach rows
taken from AP - 1 down to 0, each failing non-red row's foe where the
blocker is still negative. Lights: TrafficLight::passTime, k_phase passes
(each moving to the next phase, mod max(n, 1), where the remaining time
is <= 0 and adding its time), for intersections with phases that are
not virtual; under RL control the lights are kept.
"""

import numpy as np
import pytest
import torch

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.core import ring
from cityflow_tpu_torch.kernels import ring_exits as r2
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_follow_cases import _bits_equal

OV_HOPS = 4


def walk(c):
    """The stage's outputs (numpy) and the edges met."""
    cfg, net, rs, mid = c["cfg"], c["net"], c["rs"], c["mid"]
    SL, N, B = mid["new_dis_l"].shape
    SK, LK = cfg["SK"], cfg["LKp"]
    XKl, XKe = min(cfg["XK"], SL), min(cfg["XK"], SK)
    lc = cfg["lane_change"]
    dt = np.float32(cfg["interval"])
    nd = mid["new_dis_l"].copy()
    leave = np.zeros((SL if lc else XKl, N, B), bool)
    exited = np.zeros((XKl, N, B), bool)
    chanA = np.zeros((SL, N, B), np.float32)
    chanB = np.zeros((SL, N, B), np.float32)
    x_l = np.zeros((N, B), np.int32)
    n_rm = np.zeros(B, np.int32)
    t_rm = np.zeros(B, np.float64)
    ov = np.zeros(B, np.int32)
    ev = set()
    for b in range(B):
        now = np.float32(rs["step"][b]) * dt
        for p in range(N):
            n = int(rs["n_l"][p, b])
            ln = net["ln_len"][p]
            ev.add("empty" if n == 0 else "full" if n == SL else "some")
            pref = True
            for s in range(SL):
                occ = s < n
                last = bool(rs["l_last"][s, p, b])
                v = nd[s, p, b]
                if occ and rs["l_nxt"][s, p, b] < 0 and not last:
                    if not np.isnan(v) and v > ln:
                        ev.add("clamped")
                        v = ln
                    nd[s, p, b] = v
                cross = occ and v > ln
                if s >= XKl:
                    if cross:
                        ov[b] = OV_HOPS
                        ev.add("deep_crossing")
                    continue
                pref = pref and cross
                leave[s, p, b] = pref
                x_l[p, b] += pref
                sh = lc and bool(rs["l_sh"][s, p, b])
                if pref and (last or sh):
                    n_rm[b] += 1
                    t_rm[b] += np.float32(now - rs["l_enter"][s, p, b])
                    ev.add("removed_shadow" if sh and not last
                           else "removed_last")
                exited[s, p, b] = pref and not last and not sh \
                    and rs["l_nxt"][s, p, b] >= 0
                chanA[s, p, b] = pref and not last
                chanB[s, p, b] = pref and last
            if n > XKl and x_l[p, b] < XKl:
                ev.add("prefix_broken")
    # links
    ndk = mid["nd_k3"].reshape(SK, LK, B)
    fail = mid["k_fail"].reshape(SK, LK, B)
    foe = mid["k_fffoe"].reshape(SK, LK, B)
    AP = mid["ap_fail"].shape[0]
    apf, apr, apo = (mid[k].reshape(AP, LK, B)
                     for k in ("ap_fail", "ap_red", "ap_ffo"))
    leave_k = np.zeros((XKe, LK, B), bool)
    x_k = np.zeros((LK, B), np.int32)
    blk = np.full((LK, B), -1, np.int32)
    for b in range(B):
        for k in range(LK):
            n = int(rs["n_k"][k, b])
            pref = True
            for s in range(SK):
                cross = s < n and ndk[s, k, b] > net["lk_len"][k]
                if s >= XKe:
                    if cross:
                        ov[b] = OV_HOPS
                    continue
                pref = pref and cross
                leave_k[s, k, b] = pref
                x_k[k, b] += pref
            fails = [s for s in range(min(n, SK)) if fail[s, k, b]]
            if len(fails) > 1:
                ev.add("several_failing")
            v = foe[fails[0], k, b] if fails else -1
            for a in reversed(range(AP)):
                if v < 0 and apf[a, k, b]:
                    ev.add("approach_red" if apr[a, k, b]
                           else "approach_taken")
                    if not apr[a, k, b]:
                        v = apo[a, k, b]
            blk[k, b] = v
    # lights
    phase, remain = rs["phase"].copy(), rs["phase_remain"].copy()
    if not cfg["rl_traffic_light"]:
        pt = net["phase_time"]
        for i in range(cfg["I"]):
            nph = int(net["i_n_phases"][i])
            has = nph > 0 and not net["i_virtual"][i]
            ev.add("virtual" if net["i_virtual"][i]
                   else f"phases_{min(nph, 2)}")
            for b in range(B):
                ph, rem = int(phase[i, b]), remain[i, b]
                if has:
                    rem = np.float32(rem - dt)
                passes = 0
                for _ in range(cfg["k_phase"]):
                    if has and rem <= 0:
                        ph = (ph + 1) % max(nph, 1)
                        j = min(max(int(net["i_phase_offset"][i]) + ph, 0),
                                len(pt) - 1)
                        rem = np.float32(rem + pt[j])
                        passes += 1
                if passes > 1:
                    ev.add("several_passes")
                phase[i, b], remain[i, b] = ph, rem
    else:
        ev.add("rl_lights")
    out = dict(dis_l=nd, leave=leave, exited=exited, x_l=x_l, n_rm=n_rm,
               t_rm=t_rm, leave_k=leave_k, x_k=x_k, blk=blk, phase=phase,
               remain=remain, ov=ov)
    if lc:
        out.update(chanA=chanA, chanB=chanB)
    return out, ev


@pytest.mark.parametrize("name", kc.EXITS_CASES)
def test_exits_plain_matches_reference_walk(name):
    case = kc.exits_case(name)
    want, _ = walk(case)
    a = kc.exits_args(case, "cpu")
    got = r2.ring_exits(*a)
    assert set(got) == set(want), set(got) ^ set(want)
    # the clamp is written into mid's new distances
    assert got["dis_l"] is a[3]["new_dis_l"]
    for key, w in want.items():
        g = got[key].numpy()
        if key == "t_rm":
            assert np.all(np.abs(g - w) <= 1e-6 * np.abs(w)), (name, key)
        else:
            assert _bits_equal(g, w.astype(g.dtype)) == 0, (name, key)


def test_exits_cases_reach_their_edges():
    """B = 1, 3, 128 and 130, lane change on and off, RL lights, a view
    one element in; lanes empty, full and in between, the invalid clamp,
    removals of vehicles at their route's end and of shadows, a crossing
    behind the leave prefix (OV_HOPS) and envs without one, links with
    several failing slots, approach rows red and taken, intersections
    with 0, 1 and several phases and virtual ones, several passes of
    TrafficLight::passTime in one step."""
    seen = {"B": set(), "lc": set()}
    union = set()
    ov_clear = False
    for _, c in kc.exits_cases():
        seen["B"].add(c["mid"]["new_dis_l"].shape[-1])
        seen["lc"].add(c["cfg"]["lane_change"])
        out, ev = walk(c)
        union |= ev
        ov_clear |= bool((out["ov"] == 0).any())
        union |= {"offset"} if c["offset"] else set()
    assert {1, 3, 128, 130} <= seen["B"] and seen["lc"] == {True, False}
    assert ov_clear
    want = {"empty", "full", "some", "clamped", "deep_crossing",
            "prefix_broken", "removed_last", "removed_shadow",
            "several_failing", "approach_red", "approach_taken", "virtual",
            "phases_0", "phases_1", "phases_2", "several_passes",
            "rl_lights", "offset"}
    assert want <= union, want - union


def test_exits_refuses_a_strided_view():
    """The stage writes the new distances in place: a view that is not
    contiguous is refused (on the CPU too: the checks run before either
    branch)."""
    a = kc.exits_args(kc.exits_case(kc.EXITS_CASES[0]), "cpu")
    nd = a[3]["new_dis_l"]
    wide = torch.zeros(nd.shape[:-1] + (2 * nd.shape[-1],))
    a[3]["new_dis_l"] = wide[..., ::2]
    with pytest.raises(ValueError, match="not contiguous"):
        r2.ring_exits(*a)


def test_single_env_p2_leaves_mid_as_it_was():
    """The batched p2 clamps p1's mid["new_dis_l"] in place (it comes back
    as R2's dis_l); the single-env ring_step_p2 copies it first, so the
    caller's mid stays as it was and a second p2 from it is the same."""
    sim = ring_sim.build_sim(compile_scenario(
        "tests/fixtures/config_4x4.json"), horizon=40, device="cpu")
    st = sim.state
    for _ in range(25):
        st = ring.ring_step(sim.tables, sim.cfg, st, sim.q)
    rs1, mid = ring.ring_step_p1(sim.tables, sim.cfg, st, sim.q)
    before = {k: v.clone() for k, v in mid.items()}
    a = ring.ring_step_p2(sim.tables, sim.cfg, rs1, mid)
    for k, v in before.items():
        assert torch.equal(mid[k], v), k
    b = ring.ring_step_p2(sim.tables, sim.cfg, rs1, mid)
    for k, v in a.leaves().items():
        assert torch.equal(getattr(b, k), v), k
    seen = []
    orig = ring.ring_exits

    def spy(cfg, net, rs, m):
        out = orig(cfg, net, rs, m)
        seen.append(out["dis_l"] is m["new_dis_l"])
        return out
    ring.ring_exits = spy
    try:
        bst, bmid = ring.ring_step_p1_batched(
            sim.tables, sim.cfg, ring.batch_ring_state(st, 2), sim.q)
        ring.ring_step_p2_batched(sim.tables, sim.cfg, bst, bmid)
    finally:
        ring.ring_exits = orig
    assert seen == [True]


class _OffsetLimitLib:
    """Stands in for the kernel library: records the offset limit of each
    exits launch (ring_exits_groups gives one group of each kind)."""

    def __init__(self):
        self.off_lim = []

    def ring_exits_groups(self, B, LNp, LKp, nlg, nkg):
        nlg._obj.value = nkg._obj.value = 1
        return 0

    def ring_exits(self, aref, mode, stream):
        self.off_lim.append((mode, aref._obj.off_lim))
        return 0


@pytest.mark.parametrize("limit", [None, 0])
def test_exits_launch_passes_the_offset_limit(monkeypatch, limit):
    """The exits launch hands ring_exits.OFFSET_LIMIT (2^31 - 1) to the
    kernel, which takes 32-bit offsets below it; set to 0 (as chip_smoke.py
    does to hold the 64-bit instantiation to the plain version on the
    card) every launch gets 0."""
    lib = _OffsetLimitLib()
    monkeypatch.setattr(r2._lib, "lib", lambda: lib)
    monkeypatch.setattr(r2._lib, "stream_ptr", lambda t: 0)
    if limit is not None:
        monkeypatch.setattr(r2, "OFFSET_LIMIT", limit)
    r2._launch_exits(*kc.exits_args(kc.exits_case(kc.EXITS_CASES[0]), "cpu"))
    want = 2 ** 31 - 1 if limit is None else limit
    assert lib.off_lim == [(r2.MODES["exits"], want)]
