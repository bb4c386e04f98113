"""The gen-1 step's kernel regions, module by module, against the JAX
package's functions jitted under x64: G1 arrange, G2 leader_scan, G3
notify_cross (through foe_view) and get_action with G4 cross_pass, all
four through their plain versions (this host has no card), bitwise, on
the states the port's engine records at three steps of config_4x4.json
and two of config_2x2.json, where vehicles yield at crosses (after that
step's spawn and admission, where the step calls them)."""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cityflow_tpu.core import state as jstate
from cityflow_tpu.core import step as js
from cityflow_tpu.engine import _net_device_arrays

from cityflow_tpu_torch.carry import sim_state_to_numpy
from cityflow_tpu_torch.core import step as ts
from cityflow_tpu_torch.engine import Engine
from cityflow_tpu_torch.kernels.arrange import link_rows

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
CASES = (("config_4x4.json", 30), ("config_4x4.json", 80),
         ("config_4x4.json", 95), ("config_2x2.json", 37),
         ("config_2x2.json", 187))


@partial(jax.jit, static_argnums=(1,))
def _jax_regions(net, cfg, st):
    """The JAX package's regions on one post-admission state."""
    cyc = js.blocker_cycles(cfg, st.blocker)
    fattrs, iattrs = js.build_attr_packs(cfg, st, cyc)
    veh_len = st.params[:, js.P_LEN]
    arr = js.arrangement(net, cfg, st.running, st.drv, st.dis, st.list_seq,
                         veh_len, fattrs=fattrs, iattrs=iattrs)
    arr_bare = js.arrangement(net, cfg, st.running, st.drv, st.dis,
                              st.list_seq, veh_len)
    ll_avail = js.lanelink_available(net, cfg, st)
    veh_next, _ = js.chain_step(net, cfg, st.route, st.route_pos, st.drv)
    foe = js.notify_cross(net, cfg, st, arr, veh_next, ll_avail, fattrs,
                          iattrs)
    buf, ov_hop = js.get_action(net, cfg, st, arr, veh_next, ll_avail, foe)
    scan = js.leader_scan(net, cfg, st, arr, st.running)
    return dict(arr=arr, arr_bare=arr_bare, foe=foe, buf=buf, ov_hop=ov_hop,
                scan=scan)


def _port_regions(eng, st):
    """The port's regions on one env's state, run as a batch of one (G1
    has no pack or table: `links` is each lanelink's first k_link
    vehicles read through its sorted_idx and drv_off, `cyc` G9's flags)."""
    net, cfg = eng._net_dev, eng.cfg
    st = ts.lift(st)
    cyc = ts.blocker_cycles(cfg, st.blocker)
    arr = ts.arrangement(net, cfg, st.running, st.drv, st.dis, st.list_seq)
    ll_avail = ts.lanelink_available(net, cfg, st)
    veh_next, _ = ts.chain_step(net, cfg.num_lanes, st.route, st.route_pos,
                                st.drv)
    own = ts.notify_cross(net, cfg, st, arr, veh_next, ll_avail, cyc)
    buf, ov_hop = ts.get_action(net, cfg, st, arr, veh_next, ll_avail, own)
    scan = ts.leader_scan(net, cfg, st, arr, st.running)
    LL = cfg.num_drivables - cfg.num_lanes
    links = link_rows(arr, cfg.num_lanes, max(LL, 1), cfg.k_link)
    return ts.squeeze(dict(arr=arr, links=links, cyc=cyc,
                           foe=ts.foe_view(net, own), buf=buf, ov_hop=ov_hop,
                           scan=scan))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.cpu().numpy()
    return np.asarray(tree)


@pytest.fixture(scope="module")
def recorded():
    out = {}
    for config in sorted({c for c, _ in CASES}):
        steps = {t for c, t in CASES if c == config}
        eng = Engine(os.path.join(HERE, "fixtures", config), device="cpu")
        jnet = _net_device_arrays(eng.net, np.float64)
        for t in range(1, max(steps) + 1):
            eng.next_step()
            if t not in steps:
                continue
            st1 = ts.squeeze(ts.step_part1(eng._net_dev, eng.cfg,
                                           ts.lift(eng.state),
                                           eng._spawn_dev)[0])
            leaves = sim_state_to_numpy(st1)
            jst = jstate.SimState(**{k: jnp.asarray(v)
                                     for k, v in leaves.items()})
            jcfg = jstate.StepConfig(**dataclasses.asdict(eng.cfg))
            out[config, t] = dict(running=leaves["running"], leaves=leaves,
                                  L=eng.cfg.num_lanes,
                                  jax=_np(_jax_regions(jnet, jcfg, jst)),
                                  port=_np(_port_regions(eng, st1)))
    return out


def test_recorded_states_reach_every_branch(recorded):
    """Vehicles on lanelinks (G1's tables, G3's link candidates), leader
    scans that hit, and vehicles yielding at a cross (G4's first fail)."""
    port = [r["port"] for r in recorded.values()]
    assert min(int(r["running"].sum()) for r in recorded.values()) > 20
    assert sum(int((p["links"] >= 0).sum()) for p in port) > 20
    assert sum(int((p["scan"][0] >= 0).sum()) for p in port) > 50
    assert sum(int((p["buf"]["blocker"] >= 0).sum()) for p in port) > 10
    assert sum(int(p["foe"]["foe_exists"].sum()) for p in port) > 10


def _eq(name, got, want):
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert got.shape == want.shape, f"{name}: {got.shape} != {want.shape}"
    bad = np.nonzero(~((got == want) | ((got != got) & (want != want))))
    assert bad[0].size == 0, (f"{name}: {bad[0].size} differ, first at "
                              f"{[b[:3].tolist() for b in bad]}")


def _rebuilt_tables(r):
    """JAX's three link tables rebuilt from the port's G1 outputs
    (sorted_idx at drv_off: `links`) and the state's leaves, in the JAX
    package's pack columns; empty rows as JAX fills them (-1, zeros)."""
    lv, p = r["leaves"], r["leaves"]["params"]
    rows = r["port"]["links"]
    s = np.clip(rows, 0, None)
    f = lv["dis"].dtype
    cols = {js.A_DIS: lv["dis"], js.A_LEN: p[:, js.P_LEN],
            js.A_SPEED: lv["speed"], js.A_MAXNEG: p[:, js.P_MAXNEGACC],
            js.A_YIELD: p[:, js.P_YIELD], js.A_UPA: p[:, js.P_USUALPOSACC],
            js.A_TURNSPD: p[:, js.P_TURNSPEED],
            js.A_MAXSPD: p[:, js.P_MAXSPEED],
            js.A_CYC: r["port"]["cyc"].astype(f),
            js.A_PREV: lv["prev_drv"].astype(f)}
    fattr = np.stack([cols[k][s] for k in range(len(cols))], -1)
    iattr = np.stack([lv["enter_ll_time"][s], lv["priority"][s]], -1)
    occ = (rows >= 0)[..., None]
    return dict(link_veh=rows, link_fattr=np.where(occ, fattr, 0.0),
                link_iattr=np.where(occ, iattr, 0).astype(np.int32))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][7:-5]}@{c[1]}")
def test_arrange_matches_jax(recorded, case):
    """G1's leader, first_of, last_of, sorted_idx and overflow equal
    JAX's arrangement; JAX's link tables (link_veh and, with the packs,
    link_fattr and link_iattr) rebuilt bitwise from drv_off and the
    leaves."""
    r = recorded[case]
    run = r["running"]
    j, p = r["jax"]["arr"], r["port"]["arr"]
    # JAX chains the slots that are not running as leaders of each other;
    # nothing reads those
    _eq("leader", p["leader"][run], j["leader"][run])
    assert (p["leader"][~run] == -1).all()
    for k in ("first_of", "last_of", "overflow_link"):
        _eq(k, p[k], j[k])
    for k, t in _rebuilt_tables(r).items():
        _eq(k, t, j[k])
    n = int(run.sum())
    _eq("sorted_idx", p["sorted_idx"][:n], j["sorted_idx"][:n])
    assert (p["sorted_idx"][n:] == np.nonzero(~run)[0]).all()
    # drv_off: each drivable's first position in JAX's sorted order
    D = len(p["first_of"])
    _eq("drv_off", p["drv_off"], np.searchsorted(
        j["sorted_drv"][:n], np.arange(D + 1)).astype(np.int32))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][7:-5]}@{c[1]}")
def test_arrange_without_packs_matches_jax(recorded, case):
    """JAX's arrangement without the packs: its leader, last_of and
    (vehicle, distance, length) link tables from the port's one G1 call
    (G1 takes no packs and returns no table)."""
    r = recorded[case]
    run = r["running"]
    j, p = r["jax"]["arr_bare"], r["port"]["arr"]
    _eq("leader", p["leader"][run], j["leader"][run])
    _eq("last_of", p["last_of"], j["last_of"])
    assert not {"link_veh", "link_fattr", "link_iattr"} & set(p)
    rows = r["port"]["links"]
    occ = rows >= 0
    s = np.clip(rows, 0, None)
    _eq("link_veh", rows, j["link_veh"])
    _eq("link_dis", np.where(occ, r["leaves"]["dis"][s], 0.0), j["link_dis"])
    _eq("link_len", np.where(occ, r["leaves"]["params"][s, js.P_LEN], 0.0),
        j["link_len"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][7:-5]}@{c[1]}")
def test_leader_scan_matches_jax(recorded, case):
    r = recorded[case]
    (jf, jg), (pf, pg) = r["jax"]["scan"], r["port"]["scan"]
    _eq("found", pf, jf)
    _eq("gap", pg, jg)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][7:-5]}@{c[1]}")
def test_notify_cross_matches_jax(recorded, case):
    j, p = recorded[case]["jax"]["foe"], recorded[case]["port"]["foe"]
    assert set(p) == set(j)
    for k in j:
        _eq(k, p[k], j[k])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][7:-5]}@{c[1]}")
def test_get_action_matches_jax(recorded, case):
    """get_action with G4 cross_pass: every buffered field."""
    r = recorded[case]
    j, p = r["jax"]["buf"], r["port"]["buf"]
    assert set(p) == set(j)
    for k in j:
        _eq(k, p[k], j[k])
    _eq("ov_hop", r["port"]["ov_hop"], r["jax"]["ov_hop"])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_stop_before_mins_take_the_reference_min(dtype):
    """getStopBeforeSpeed of a stopped vehicle with no distance left is
    0 / 0: the reference's std::min(v, NaN) keeps v (ts.ref_min), where
    torch.minimum (and JAX's jnp.minimum) give NaN. Both of the gen-1
    step's stop-before mins take it: before a red light (get_action) and
    before the first cross it must yield at (G4)."""
    t = lambda x: torch.tensor(x, dtype=dtype)
    zero, upa, una, dt = t(0.0), t(2.5), t(4.5), t(1.0)
    stop = ts.stop_before_speed(zero, upa, una, zero, dt)
    assert torch.isnan(stop)
    for cap in (t(16.67), t(11.1)):
        assert torch.isnan(torch.minimum(cap, stop))
        assert ts.ref_min(cap, stop) == cap
        assert ts.ref_min(cap, t(3.0)) == torch.minimum(cap, t(3.0))
        assert ts.ref_min(t(3.0), cap) == 3.0


def _stopped_cases(eng, st):
    """Slot A: a running lane vehicle with no vehicle ahead, its next
    lanelink red, moved to the lane end at speed 0."""
    net, cfg = eng._net_dev, eng.cfg
    L = cfg.num_lanes
    arr = ts.squeeze(ts.arrangement(net, cfg, *ts.lift((
        st.running, st.drv, st.dis, st.list_seq))))
    ll_avail = ts.lanelink_available(net, cfg, st)
    veh_next, _ = ts.chain_step(net, L, st.route, st.route_pos, st.drv)
    c = sim_state_to_numpy(st)
    nxt = veh_next.numpy()
    red = (nxt >= L) & ~ll_avail.numpy()[np.clip(nxt - L, 0, None)]
    first = arr["leader"].numpy() < 0
    a = int(np.nonzero(c["running"] & (c["drv"] < L) & red & first)[0][0])
    c["dis"][a] = eng.net.drv_len[c["drv"][a]]
    c["speed"][a] = 0.0
    return a, c


def test_get_action_keeps_a_finite_speed_where_jax_gives_nan():
    """On the recorded config_2x2.json state of step 187, slot A (red
    light, no lane left, speed 0) gets a finite speed from the port and
    NaN from JAX; the slots B (stopped, yielding at their first failing
    cross, which leaves them a distance > 0: canYield needs the brake
    distance, 0, below it) and every other slot agree bitwise."""
    from cityflow_tpu_torch.carry import sim_state_from_numpy
    eng = Engine(os.path.join(HERE, "fixtures", "config_2x2.json"),
                 device="cpu")
    for _ in range(187):
        eng.next_step()
    st1 = ts.squeeze(ts.step_part1(eng._net_dev, eng.cfg, ts.lift(eng.state),
                                   eng._spawn_dev)[0])
    a, leaves = _stopped_cases(eng, st1)
    st = sim_state_from_numpy(leaves, "cpu")
    port = _np(_port_regions(eng, st))["buf"]
    jst = jstate.SimState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jcfg = jstate.StepConfig(**dataclasses.asdict(eng.cfg))
    jax_buf = _np(_jax_regions(_net_device_arrays(eng.net, np.float64), jcfg,
                               jst))["buf"]
    assert np.isnan(jax_buf["speed"][a]) and np.isfinite(port["speed"][a])
    assert np.isfinite(port["dis"][a])
    b = np.nonzero((port["blocker"] >= 0) & (leaves["speed"] == 0.0))[0]
    assert b.size >= 3
    keep = np.arange(len(port["speed"])) != a
    for k in jax_buf:
        _eq(k, port[k][keep], jax_buf[k][keep])
    assert np.isfinite(port["speed"][b]).all()
