"""Gen-1 lane change of the port against the JAX package, module by
module, and against the reference goldens.

The modules (G6 lc_probe, G7 lc_plan in its four modes with the shadow
insert G15, G8 lc_commit in both modes) run through their plain versions
(this host has no card), each env's state lifted to a batch of one, on
post-admission states of
config_2x2_lc.json that the port's engine records at steps 238 and 273
(signals with two senders for one receiver, shadows mid-change), each
also with seeded equal distances (a probe level with a vehicle of the
side lane, two vehicles level on one lane). The JAX functions run jitted
under x64 on the same states; each port region starts from the JAX
region before it, and every output is held bitwise (ints and bools
exact, float64 at atol=0).

The step then runs against lc_single_180 (the reference's single-changer
golden: bit-exact through step 150, within 1e-6 with the same change
events through 175) and, marked slow, config_2x2_lc.json against the
reference aggregates of grid2x2_lc_400_agg.json.
"""

import dataclasses
import json
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from golden_util import (compare_step, engine_step_record,  # noqa: E402
                         golden_records)

from cityflow_tpu.core import lanechange as jlc  # noqa: E402
from cityflow_tpu.core import state as jstate  # noqa: E402
from cityflow_tpu.core import step as js  # noqa: E402
from cityflow_tpu.engine import _net_device_arrays  # noqa: E402

from cityflow_tpu_torch.carry import (  # noqa: E402
    sim_state_from_numpy, sim_state_to_numpy)
from cityflow_tpu_torch.core import lanechange as tlc  # noqa: E402
from cityflow_tpu_torch.core import step as ts  # noqa: E402
from cityflow_tpu_torch.engine import Engine  # noqa: E402
from cityflow_tpu_torch.kernels.lc_plan import lc_plan  # noqa: E402

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
CONFIG = os.path.join(FIX, "config_2x2_lc.json")
STEPS = (238, 273)
CASES = [(t, v) for t in STEPS for v in ("natural", "ties")]
INT_MIN = -2**31


@partial(jax.jit, static_argnums=(1,))
def _jax_lane_change(net, cfg, st):
    """The JAX package's lane-change regions from one post-admission
    state, in the order the step runs them."""
    cyc = js.blocker_cycles(cfg, st.blocker)
    fattrs, iattrs = js.build_attr_packs(cfg, st, cyc)
    arr = js.arrangement(net, cfg, st.running, st.drv, st.dis, st.list_seq,
                         st.params[:, js.P_LEN], fattrs=fattrs,
                         iattrs=iattrs)
    nb = jlc._probe_neighbors(net, cfg, st)
    st2 = jlc.plan_lane_change(net, cfg, st, arr)
    cyc = js.blocker_cycles(cfg, st2.blocker)
    fattrs, iattrs = js.build_attr_packs(cfg, st2, cyc)
    st3, arr3 = js.update_leader_and_gap(net, cfg, st2, fattrs, iattrs)
    y = jlc.yield_speed(net, cfg, st3)
    ll_avail = js.lanelink_available(net, cfg, st3)
    veh_next, _ = js.chain_step(net, cfg, st3.route, st3.route_pos, st3.drv)
    foe = js.notify_cross(net, cfg, st3, arr3, veh_next, ll_avail, fattrs,
                          iattrs)
    buf, ov_hop = js.get_action(net, cfg, st3, arr3, veh_next, ll_avail,
                                foe)
    st4, removed = js.update_location(net, cfg, st3, arr3, buf)
    st5 = js.commit(net, cfg, st4, buf, removed)
    return dict(nb=nb, st2=st2, st3=st3, y=y, buf=buf, ov_hop=ov_hop,
                st4=st4, removed=removed, st5=st5)


@jax.jit
def _jax_receive(plan, has_signal, priority, tleader, tfollower):
    """recv_for of the JAX package's plan_lane_change
    (core/lanechange.py:194-204), written out with its jnp calls."""
    V = priority.shape[0]
    sender_ok = plan & has_signal
    out = []
    for role in (tleader, tfollower):
        pri = jnp.where(sender_ok, priority, jnp.int32(INT_MIN))
        tgt = jnp.where(sender_ok & (role >= 0), role, V)
        best = jnp.full(V + 1, jnp.int32(INT_MIN), jnp.int32).at[tgt].max(
            pri, mode="drop")[:V]
        slot = jnp.full(V + 1, -1, jnp.int32).at[
            jnp.where(sender_ok & (js.gat(best, role) == priority)
                      & (role >= 0), role, V)].max(
            jnp.arange(V, dtype=jnp.int32), mode="drop")[:V]
        out += [best, slot]
    return dict(best_l=out[0], slot_l=out[1], best_f=out[2], slot_f=out[3])


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return {k.name: _np(getattr(tree, k.name))
                for k in dataclasses.fields(tree)}
    if torch.is_tensor(tree):
        return tree.cpu().numpy()
    return np.asarray(tree)


def _bits(a):
    a = np.asarray(a)
    if a.dtype == np.float64:
        return a.view(np.int64)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _eq(name, got, want):
    """Bitwise: ints and bools exact, floats bit for bit."""
    got, want = np.atleast_1d(np.asarray(got)), np.atleast_1d(
        np.asarray(want))
    assert got.shape == want.shape, f"{name}: {got.shape} != {want.shape}"
    if want.dtype == np.bool_ or got.dtype == np.bool_:
        got, want = got.astype(bool), want.astype(bool)
    elif want.dtype.kind in "iu":
        got, want = got.astype(np.int64), want.astype(np.int64)
    bad = np.nonzero(_bits(got) != _bits(want))
    assert bad[0].size == 0, (f"{name}: {bad[0].size} differ, first at "
                              f"{[b[:3].tolist() for b in bad]}: "
                              f"{got[bad][:3]} != {want[bad][:3]}")


def _eq_state(tag, got, want):
    for k in want:
        _eq(f"{tag}.{k}", got[k], want[k])


def _with_ties(st, L, seed):
    """Seeded equal distances: some running lane vehicles move level with
    a vehicle of their outer or inner lane (the probe meets a vehicle at
    its own distance), and on some lanes one vehicle moves level with
    another (two candidates at one distance)."""
    rng = np.random.default_rng(seed)
    c = sim_state_to_numpy(st)
    run = np.nonzero(c["running"] & (c["drv"] >= 0) & (c["drv"] < L))[0]
    by_lane = {}
    for v in run:
        by_lane.setdefault(int(c["drv"][v]), []).append(int(v))
    dis = c["dis"].copy()
    for v in rng.permutation(run)[:len(run) // 4]:
        for side in (1, -1):
            others = by_lane.get(int(c["drv"][v]) + side, [])
            if others:
                dis[v] = dis[rng.choice(others)]
                break
    for lane, vs in sorted(by_lane.items()):
        if len(vs) >= 2 and rng.random() < 0.5:
            a, b = rng.choice(vs, 2, replace=False)
            dis[a] = dis[b]
    c["dis"] = dis
    return sim_state_from_numpy(c, "cpu")


@pytest.fixture(scope="module")
def recorded():
    eng = Engine(CONFIG, device="cpu")
    net, cfg = eng._net_dev, eng.cfg
    jnet = _net_device_arrays(eng.net, np.float64)
    jcfg = jstate.StepConfig(**dataclasses.asdict(cfg))
    out = {}
    for t in range(1, max(STEPS) + 1):
        eng.next_step()
        if t not in STEPS:
            continue
        s0 = ts.spawn_vehicles(net, cfg, ts.lift(eng.state), eng._spawn_dev)
        s1 = ts.squeeze(ts.admit_waiting(net, cfg, s0,
                                         dict(last_of=s0.last_of_drv))[0])
        for variant in ("natural", "ties"):
            st = s1 if variant == "natural" else _with_ties(
                s1, cfg.num_lanes, t)
            leaves = sim_state_to_numpy(st)
            jst = jstate.SimState(**{k: jnp.asarray(v)
                                     for k, v in leaves.items()})
            out[t, variant] = dict(
                st=st, jax=_np(_jax_lane_change(jnet, jcfg, jst)))
    return eng, out


def _port_state(leaves):
    return sim_state_from_numpy(leaves, "cpu")


def _arr(eng, st):
    """G1 and G9's blocker cycles on one env's state (run as a batch of
    one)."""
    st = ts.lift(st)
    cyc = ts.blocker_cycles(eng.cfg, st.blocker)
    arr = ts.arrangement(eng._net_dev, eng.cfg, st.running, st.drv, st.dis,
                         st.list_seq)
    return ts.squeeze((arr, cyc))


def test_recorded_states_reach_every_branch(recorded):
    """Shadows mid-change, receivers with two senders, probes level with
    a side-lane vehicle, changes that start, finish and receive."""
    eng, rec = recorded
    L = eng.cfg.num_lanes
    shadows = multi = level = starts = recv = 0
    for (t, variant), r in rec.items():
        j = r["jax"]
        shadows += int((j["st2"]["is_shadow"] & j["st2"]["running"]).sum())
        recv += int((j["st2"]["lc_recv"] >= 0).sum())
        starts += int((j["st2"]["lc_changing"]
                       & ~r["st"].lc_changing.numpy()).sum())
        plan = ((j["st2"]["lc_has_signal"] & (j["st2"]["lc_target"] >= 0)
                 & (j["st2"]["lc_target"] != r["st"].drv.numpy()))
                | r["st"].lc_changing.numpy())
        so = plan & j["st2"]["lc_has_signal"]
        roles = np.concatenate([j["st2"]["lc_tleader"][so],
                                j["st2"]["lc_tfollower"][so]])
        roles = roles[roles >= 0]
        multi += int((np.bincount(roles) >= 2).sum()) if roles.size else 0
        dis = r["st"].dis.numpy()
        for side in ("outer", "inner"):
            lead = j["nb"][side + "_leader"]
            ok = (lead >= 0) & (j["nb"][side + "_lane"] < L)
            level += int((dis[lead[ok]] == dis[ok]).sum())
    assert shadows >= 4 and multi >= 2 and level >= 4 and recv >= 1
    assert starts >= 1


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}@{c[0]}")
def test_lc_probe_matches_jax(recorded, case):
    """G6 against _probe_neighbors (the stable 3V sort)."""
    eng, rec = recorded
    r = rec[case]
    arr = _arr(eng, r["st"])[0]
    nb = ts.squeeze(tlc.probe_neighbors(eng._net_dev, eng.cfg,
                                        *ts.lift((r["st"], arr))))
    _eq_state("nb", _np(nb), r["jax"]["nb"])


def test_lc_probe_orders_signed_zeros_and_nans_as_jax(recorded):
    """G1 and G6 against JAX's arrangement and _probe_neighbors where lane
    vehicles stand at -0.0, +0.0 and NaN (of both signs) beside vehicles
    at other distances: lax.sort ties the two zeros and every NaN (after
    +inf), so a probe at +0.0 takes a vehicle at -0.0 as its leader."""
    eng, rec = recorded
    net, cfg = eng._net_dev, eng.cfg
    L = cfg.num_lanes
    c = {k: np.array(v) for k, v in sim_state_to_numpy(
        rec[STEPS[0], "natural"]["st"]).items()}     # a copy: the fixture's
    rng = np.random.default_rng(5)                   # state stays as it was
    lane = np.nonzero(c["running"] & (c["drv"] >= 0) & (c["drv"] < L))[0]
    c["dis"][lane] = rng.choice(np.array([0.0, -0.0, np.nan, -np.nan, 3.0,
                                          40.0]), lane.size)
    st = sim_state_from_numpy(c, "cpu")
    jst = jstate.SimState(**{k: jnp.asarray(v) for k, v in c.items()})
    jcfg = jstate.StepConfig(**dataclasses.asdict(cfg))
    jnet = _net_device_arrays(eng.net, np.float64)
    jarr, jnb = jax.jit(lambda n, s: (
        js.arrangement(n, jcfg, s.running, s.drv, s.dis, s.list_seq,
                       s.params[:, js.P_LEN]),
        jlc._probe_neighbors(n, jcfg, s)))(jnet, jst)
    arr = _arr(eng, st)[0]
    run = c["running"]
    _eq("leader", arr["leader"].numpy()[run], np.asarray(jarr["leader"])[run])
    for k in ("first_of", "last_of"):
        _eq(k, arr[k].numpy(), np.asarray(jarr[k]))
    nb = ts.squeeze(tlc.probe_neighbors(net, cfg, *ts.lift((st, arr))))
    _eq_state("nb", _np(nb), _np(jnb))
    zero = c["dis"][lane] == 0
    assert (zero & np.signbit(c["dis"][lane])).any() and (
        zero & ~np.signbit(c["dis"][lane])).any()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}@{c[0]}")
def test_lc_plan_modes_match_jax(recorded, case):
    """G7 signal, receive and decide against plan_lane_change's results:
    the signal fields it stores, recv_for's two scatter-max passes, the
    signal kept and the changes started."""
    eng, rec = recorded
    r = rec[case]
    st, j2 = r["st"], r["jax"]["st2"]
    net, L = eng._net_dev, eng.cfg.num_lanes
    arr = _arr(eng, st)[0]
    bst, barr = ts.lift((st, arr))
    nb = tlc.probe_neighbors(net, eng.cfg, bst, barr)
    bsig = lc_plan("signal", bst, net, L, nb=nb, last_of=barr["last_of"])
    sig = ts.squeeze(bsig)
    # the shadow insert wrote the new shadows' slots after these fields
    new = j2["active"] & ~st.active.numpy()
    assert new.any() or case[1] == "ties"
    for k, jk in (("has_signal", "lc_has_signal"), ("target", "lc_target"),
                  ("direction", "lc_dir"), ("tleader", "lc_tleader"),
                  ("tfollower", "lc_tfollower"), ("lgap", "lc_lgap"),
                  ("fgap", "lc_fgap")):
        _eq(k, sig[k].numpy()[~new], j2[jk][~new])
    drv, real = st.drv.numpy(), ~st.is_shadow.numpy()
    plan = (((j2["lc_has_signal"] & (j2["lc_target"] >= 0)
              & (j2["lc_target"] != drv)) | st.lc_changing.numpy())
            & st.running.numpy() & real)
    _eq("plan", sig["plan"].numpy()[~new], plan[~new])
    # recv_for runs on the fields as planned: the new shadows' slots hold
    # what the signal phase gave them
    j2 = dict(j2, **{jk: np.where(new, sig[k].numpy(), j2[jk]) for k, jk in (
        ("has_signal", "lc_has_signal"), ("tleader", "lc_tleader"),
        ("tfollower", "lc_tfollower"))})
    plan = np.where(new, sig["plan"].numpy(), plan)
    brcv = lc_plan("receive", bst, net, L, sig=bsig)
    rcv = ts.squeeze(brcv)
    want = _np(_jax_receive(jnp.asarray(plan), jnp.asarray(
        j2["lc_has_signal"]), jnp.asarray(st.priority.numpy()),
        jnp.asarray(j2["lc_tleader"]), jnp.asarray(j2["lc_tfollower"])))
    _eq_state("receive", _np(rcv), want)
    dec = ts.squeeze(lc_plan("decide", bst, net, L, sig=bsig, rcv=brcv))
    _eq("lc_recv", dec["lc_recv"].numpy()[~new], j2["lc_recv"][~new])
    _eq("do_change", dec["do_change"].numpy()[~new],
        (j2["lc_changing"] & ~st.lc_changing.numpy())[~new])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}@{c[0]}")
def test_plan_lane_change_with_shadow_insert_matches_jax(recorded, case):
    """G6 + G7 + the plain shadow insert: every SimState leaf. The insert
    writes the state it is given in place: it gets a copy."""
    eng, rec = recorded
    r = rec[case]
    arr = _arr(eng, r["st"])[0]
    st = r["st"].map(torch.clone)
    st2 = ts.squeeze(tlc.plan_lane_change(eng._net_dev, eng.cfg,
                                          *ts.lift((st, arr))))
    _eq_state("st2", sim_state_to_numpy(st2), r["jax"]["st2"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}@{c[0]}")
def test_lc_yield_and_get_action_tail_match_jax(recorded, case):
    """G7 yield against yield_speed, and get_action under lane change
    (the yield min, the real / shadow lockstep, G8's tail): every
    buffered field, from JAX's state after the second leader update."""
    eng, rec = recorded
    j = rec[case]["jax"]
    net, cfg = eng._net_dev, eng.cfg
    st3 = _port_state(j["st3"])
    _eq("yield", ts.squeeze(tlc.yield_speed(net, cfg, ts.lift(st3))).numpy(),
        j["y"])
    arr, cyc = _arr(eng, st3)
    ll_avail = ts.lanelink_available(net, cfg, st3)
    veh_next, _ = ts.chain_step(net, cfg.num_lanes, st3.route,
                                st3.route_pos, st3.drv)
    b = ts.lift((st3, arr, veh_next, ll_avail))
    own = ts.notify_cross(net, cfg, *b, ts.lift(cyc))
    buf, ov_hop = ts.squeeze(ts.get_action(net, cfg, *b, own))
    assert set(buf) == set(j["buf"])
    _eq_state("buf", _np(buf), j["buf"])
    _eq("ov_hop", ov_hop.numpy(), j["ov_hop"])
    assert j["buf"]["offset"].any() and j["buf"]["end"].any()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}@{c[0]}")
def test_lc_commit_matches_jax(recorded, case):
    """update_location (finished changes are not finished trips) and
    commit with G8's commit mode, from JAX's buffers."""
    eng, rec = recorded
    j = rec[case]["jax"]
    net, cfg = eng._net_dev, eng.cfg
    st3 = _port_state(j["st3"])
    arr = _arr(eng, st3)[0]
    buf = {k: torch.as_tensor(np.array(v, np.int32 if v.dtype.kind == "i"
                                       else v.dtype))
           for k, v in j["buf"].items()}
    st4, removed = ts.squeeze(ts.update_location(net, cfg,
                                                 *ts.lift((st3, arr, buf))))
    _eq("removed", removed.numpy(), j["removed"])
    _eq_state("st4", sim_state_to_numpy(st4), j["st4"])
    st5 = ts.squeeze(ts.commit(net, cfg, *ts.lift((
        _port_state(j["st4"]), buf, torch.as_tensor(j["removed"])))))
    _eq_state("st5", sim_state_to_numpy(st5), j["st5"])


def _is_lane_change(a, b):
    """A drivable transition within one road (tests/test_lc_single.py)."""
    if a == b or "_TO_" in a or "_TO_" in b:
        return False
    return a.rsplit("_", 1)[0] == b.rsplit("_", 1)[0]


def _count_changes(prev, items, acc):
    for vid, drv in items:
        if vid in prev and _is_lane_change(prev[vid], drv):
            acc.append(vid)
        prev[vid] = drv


def test_single_changer_matches_the_reference_golden():
    """lc_single_180: bit-exact through step 150 (before the first
    change), then within 1e-6 with the same change events through 175
    (tests/test_lc_single.py's two checks); get_leader of a shadow is its
    real's."""
    eng = Engine(os.path.join(FIX, "config_lc_single.json"), device="cpu")
    gold = golden_records("lc_single_180.jsonl.gz")
    next(gold)
    ev_g, ev_m, prev_g, prev_m = [], [], {}, {}
    shadows_seen = 0
    for t in range(1, 176):
        eng.next_step()
        g = next(gold)
        errs = compare_step(eng, g, t, atol=0.0 if t <= 150 else 1e-6,
                            ignore_shadow=True)
        assert not errs, (t, errs[:4])
        _count_changes(prev_g, [(v["id"], v["drv"]) for v in g["vehicles"]],
                       ev_g)
        mine = engine_step_record(eng)
        _count_changes(prev_m, [(k, v["drv"]) for k, v in mine.items()
                                if not k.endswith("_shadow")], ev_m)
        for vid in mine:
            if vid.endswith("_shadow"):
                # a shadow's leader answers through its real twin
                # (engine.cpp:842-845)
                shadows_seen += 1
                assert eng.get_leader(vid) == eng.get_leader(vid[:-7])
        if t == 150:
            assert not ev_g and not ev_m
    assert len(ev_g) >= 1 and shadows_seen > 0
    assert ev_m == ev_g


@pytest.mark.slow
def test_grid_lane_change_aggregates_track_the_reference():
    """config_2x2_lc.json against the reference's per-step vehicle count
    and average travel time (tests/test_lane_change.py's bounds)."""
    with open(os.path.join(HERE, "goldens", "grid2x2_lc_400_agg.json")) as f:
        gold = json.load(f)
    eng = Engine(CONFIG, device="cpu")
    cnt_diffs, att_rel = [], 0.0
    for t, g_cnt, g_att in gold[:400]:
        eng.next_step()
        cnt_diffs.append(abs(eng.get_vehicle_count() - g_cnt))
        if t > 100:
            att_rel = max(att_rel,
                          abs(eng.get_average_travel_time() - g_att) / g_att)
    mean_diff = sum(cnt_diffs) / len(cnt_diffs)
    assert mean_diff <= 0.05 * max(g[1] for g in gold) + 5, \
        (mean_diff, max(cnt_diffs))
    assert att_rel < 0.10, att_rel
    assert int(eng.state.overflow) == 0
