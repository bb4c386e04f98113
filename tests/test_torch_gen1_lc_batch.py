"""Batched gen-1 lane change and the DURATION history of the PyTorch port
(G5-G8 and G15 with the env axis, the batched step, bench --layout gen1 on
a lane-change config) on the CPU, where every kernel wrapper takes its
plain version.

The regions run over B envs whose states differ (config_2x2_lc.json at
steps 238 and 273, and a seeded equal-distance variant: signals with two
senders for one receiver, shadows mid-change, a probe level with a
vehicle of the side lane) against jax.vmap of the JAX package's regions
on the same batch, jitted under x64: every leaf bitwise in float64, the
speed sums of the history window within the tolerance
tests/test_torch_gen1_duration.py states. The batched step then runs from
distinct warm states against each env stepped alone (bitwise, exact and
fast mode) and against JAX's vmapped fast step.
"""

import dataclasses
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cityflow_tpu.core import lanechange as jlc
from cityflow_tpu.core import state as jstate
from cityflow_tpu.core import step as js
from cityflow_tpu.engine import _net_device_arrays
from cityflow_tpu.parallel import batch as jbatch

from cityflow_tpu_torch.carry import sim_state_from_numpy, sim_state_to_numpy
from cityflow_tpu_torch.core import lanechange as tlc
from cityflow_tpu_torch.core import step as ts
from cityflow_tpu_torch.core.state import (
    OV_SLOTS, SIM_FIELDS, SLOT_FILL, SimState, pad_state)
from cityflow_tpu_torch.engine import Engine
from cityflow_tpu_torch.kernels import shadow_insert as g15
from cityflow_tpu_torch.kernels.lc_plan import lc_plan
from cityflow_tpu_torch.parallel.batch import make_batched_step
from test_torch_gen1_batch import _bitwise
from test_torch_gen1_duration import SUM_RTOL
from test_torch_gen1_fast import F32_TOL, _mismatches
from test_torch_gen1_lc import _eq, _eq_state, _np, _with_ties

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
CONFIG = os.path.join(FIX, "config_2x2_lc.json")
# the envs of the batch: (engine step, variant)
ENVS = ((238, "natural"), (273, "natural"), (273, "ties"))
WARM = (100, 115, 130)          # warm states of the batched-step tests
STEPS = 40
JAX_STEPS = 8


def _stack(states):
    """Single-env SimStates of one pool size as a batch."""
    return SimState(**{k: torch.stack([getattr(s, k) for s in states])
                       .contiguous() for k in SIM_FIELDS})


def _same_pool(states, least=0):
    """The states in one pool of at least `least` slots."""
    V = max([least] + [s.active.shape[0] for s in states])
    return [pad_state(s, V) for s in states]


def _jstate(leaves):
    return jstate.SimState(**{k: jnp.asarray(v) for k, v in leaves.items()})


@partial(jax.jit, static_argnums=(1,))
def _jax_regions(net, cfg, st):
    """jax.vmap of the JAX package's lane-change regions from each env's
    post-admission state, in the order the step runs them."""
    def one(s):
        cyc = js.blocker_cycles(cfg, s.blocker)
        fattrs, iattrs = js.build_attr_packs(cfg, s, cyc)
        arr = js.arrangement(net, cfg, s.running, s.drv, s.dis, s.list_seq,
                             s.params[:, js.P_LEN], fattrs=fattrs,
                             iattrs=iattrs)
        nb = jlc._probe_neighbors(net, cfg, s)
        s2 = jlc.plan_lane_change(net, cfg, s, arr)
        cyc = js.blocker_cycles(cfg, s2.blocker)
        fattrs, iattrs = js.build_attr_packs(cfg, s2, cyc)
        s3, arr3 = js.update_leader_and_gap(net, cfg, s2, fattrs, iattrs)
        y = jlc.yield_speed(net, cfg, s3)
        ll_avail = js.lanelink_available(net, cfg, s3)
        veh_next, _ = js.chain_step(net, cfg, s3.route, s3.route_pos, s3.drv)
        foe = js.notify_cross(net, cfg, s3, arr3, veh_next, ll_avail,
                              fattrs, iattrs)
        buf, ov_hop = js.get_action(net, cfg, s3, arr3, veh_next, ll_avail,
                                    foe)
        s4, removed = js.update_location(net, cfg, s3, arr3, buf)
        s5 = js.commit(net, cfg, s4, buf, removed)
        return dict(nb=nb, st2=s2, st3=s3, y=y, buf=buf, ov_hop=ov_hop,
                    st4=s4, removed=removed, st5=s5)
    return jax.vmap(one)(st)


@pytest.fixture(scope="module")
def recorded():
    """The port's post-admission states of ENVS as one batch, the same
    batch with env 1's pool made full, and JAX's vmapped regions of
    both."""
    eng = Engine(CONFIG, device="cpu")
    net, cfg = eng._net_dev, eng.cfg
    states = {}
    for t in range(1, max(t for t, _ in ENVS) + 1):
        eng.next_step()
        if t not in {t for t, _ in ENVS}:
            continue
        s0 = ts.spawn_vehicles(net, cfg, ts.lift(eng.state), eng._spawn_dev)
        s1 = ts.squeeze(ts.admit_waiting(net, cfg, s0,
                                         dict(last_of=s0.last_of_drv))[0])
        states[t, "natural"] = s1
        states[t, "ties"] = _with_ties(s1, cfg.num_lanes, t)
    bst = _stack(_same_pool([states[e] for e in ENVS]))
    full = bst.replace_fields(active=bst.active.clone())
    full.active[1] = True
    jnet = _net_device_arrays(eng.net, np.float64)
    jcfg = jstate.StepConfig(**dataclasses.asdict(
        dataclasses.replace(cfg, max_vehicles=bst.active.shape[1])))
    jax_out = {name: _np(_jax_regions(jnet, jcfg, _jstate(
        sim_state_to_numpy(s)))) for name, s in (("batch", bst),
                                                 ("full", full))}
    return dict(eng=eng, net=net, cfg=cfg, st=bst, full=full, jax=jax_out)


def _arr(net, cfg, st):
    """G1 and G9's blocker cycles on a batch's state."""
    cyc = ts.blocker_cycles(cfg, st.blocker)
    arr = ts.arrangement(net, cfg, st.running, st.drv, st.dis, st.list_seq)
    return arr, cyc


def test_the_envs_differ_and_reach_every_branch(recorded):
    """The envs hold different states, and the batch has shadows, new
    changes and receivers with two senders."""
    st, j = recorded["st"], recorded["jax"]["batch"]
    for a, b in ((0, 1), (1, 2), (0, 2)):
        assert not torch.equal(st.dis[a], st.dis[b])
    new = j["st2"]["active"] & ~st.active.numpy()
    assert (new.sum(-1) > 0).sum() >= 2, "shadows inserted in < 2 envs"
    assert (j["st2"]["lc_recv"] >= 0).any()
    assert (j["st2"]["is_shadow"] & j["st2"]["running"]).sum() >= 4


def test_lc_probe_batched_matches_jax(recorded):
    """G6 over the batch against vmap of _probe_neighbors (the stable 3V
    sort per env)."""
    net, cfg, st = recorded["net"], recorded["cfg"], recorded["st"]
    arr = _arr(net, cfg, st)[0]
    nb = tlc.probe_neighbors(net, cfg, st, arr)
    _eq_state("nb", _np(nb), recorded["jax"]["batch"]["nb"])


@pytest.mark.parametrize("which", ["batch", "full"])
def test_plan_and_shadow_insert_batched_match_jax(recorded, which):
    """G6 + G7 (signal, receive, decide) + the shadow insert over the
    batch against vmap of plan_lane_change: every SimState leaf bitwise.
    With env 1's pool full, its changers find no slot: OV_SLOTS in its
    own overflow only, the other envs as in the batch. The insert writes
    the state it is given in place: it gets a copy."""
    net, cfg = recorded["net"], recorded["cfg"]
    st = recorded["st" if which == "batch" else which]
    arr = _arr(net, cfg, st)[0]
    st2 = tlc.plan_lane_change(net, cfg, st.map(torch.clone), arr)
    want = recorded["jax"][which]["st2"]
    _eq_state("st2", sim_state_to_numpy(st2), want)
    if which == "full":
        assert want["overflow"][1] & OV_SLOTS
        assert not (want["overflow"][[0, 2]] & OV_SLOTS).any()
        assert (want["seq_counter"] == st.seq_counter.numpy() + 1).all()


def test_lc_plan_receive_batched_is_per_env(recorded):
    """G7 receive over the batch equals G7 receive of each env alone:
    every winner is a slot of its own env (a batch of one each)."""
    net, cfg, st = recorded["net"], recorded["cfg"], recorded["st"]
    L = cfg.num_lanes
    arr = _arr(net, cfg, st)[0]
    nb = tlc.probe_neighbors(net, cfg, st, arr)
    sig = lc_plan("signal", st, net, L, nb=nb, last_of=arr["last_of"])
    rcv = lc_plan("receive", st, net, L, sig=sig)
    for b in range(st.step.shape[0]):
        one = lambda x: ts.lift(x.map(lambda t: t[b]) if isinstance(
            x, SimState) else {k: v[b] for k, v in x.items()})
        alone = lc_plan("receive", one(st), net, L, sig=one(sig))
        for k in rcv:
            _eq(f"{k}[{b}]", rcv[k][b].numpy(), alone[k][0].numpy())
    assert (rcv["slot_l"] >= 0).any() or (rcv["slot_f"] >= 0).any()


def test_yield_tail_and_commit_batched_match_jax(recorded):
    """G7 yield, get_action under lane change (the yield min, the real /
    shadow lockstep, G8's tail) and update_location + commit (G8's
    commit) over the batch from JAX's states: every leaf bitwise."""
    net, cfg = recorded["net"], recorded["cfg"]
    j = recorded["jax"]["batch"]
    st3 = sim_state_from_numpy(j["st3"], "cpu")
    _eq("yield", tlc.yield_speed(net, cfg, st3).numpy(), j["y"])
    arr, cyc = _arr(net, cfg, st3)
    ll_avail = ts.lanelink_available(net, cfg, st3)
    veh_next, _ = ts.chain_step(net, cfg.num_lanes, st3.route,
                                st3.route_pos, st3.drv)
    own = ts.notify_cross(net, cfg, st3, arr, veh_next, ll_avail, cyc)
    buf, ov_hop = ts.get_action(net, cfg, st3, arr, veh_next, ll_avail, own)
    assert set(buf) == set(j["buf"])
    _eq_state("buf", _np(buf), j["buf"])
    _eq("ov_hop", ov_hop.numpy(), j["ov_hop"])
    assert j["buf"]["offset"].any() and j["buf"]["end"].any()
    st4, removed = ts.update_location(net, cfg, st3, arr, buf)
    _eq("removed", removed.numpy(), j["removed"])
    _eq_state("st4", sim_state_to_numpy(st4), j["st4"])
    st5 = ts.commit(net, cfg, sim_state_from_numpy(j["st4"], "cpu"), buf,
                    torch.as_tensor(np.array(j["removed"])))
    _eq_state("st5", sim_state_to_numpy(st5), j["st5"])


@partial(jax.jit, static_argnums=(0,))
def _jax_update_history(cfg, st):
    return jax.vmap(lambda s: js.update_history(cfg, s))(st)


def test_hist_window_batched_matches_jax(recorded):
    """G5 over the batch, each env with its own seeded window and its own
    hist_t (filling, at the wrap, full), against vmap of update_history:
    ring rows, counts and hist_t exact, speed sums within SUM_RTOL; each
    env writes only its own ring row."""
    net, st = recorded["net"], recorded["st"]
    cfg = dataclasses.replace(recorded["cfg"], track_history=True)
    HL1, L = cfg.history_len + 1, cfg.num_lanes
    hist_t = np.array([7, 241, 700], np.int32)
    rng = np.random.default_rng(9)
    num = np.zeros((3, HL1, L))
    for b, t in enumerate(hist_t):
        num[b, :min(t, HL1)] = rng.integers(0, 12, (min(t, HL1), L))
    ssum = num * rng.uniform(0.0, 16.7, num.shape)
    c = sim_state_to_numpy(st)
    c.update(hist_ring_num=num, hist_ring_ssum=ssum, hist_num=num.sum(1),
             hist_ssum=ssum.sum(1), hist_t=hist_t)
    bst = sim_state_from_numpy(c, "cpu")
    arr = ts.arrangement(net, cfg, bst.running, bst.drv, bst.dis,
                         bst.list_seq)
    got = sim_state_to_numpy(ts.update_history(cfg, bst, arr))
    jcfg = jstate.StepConfig(**dataclasses.asdict(
        dataclasses.replace(cfg, max_vehicles=st.active.shape[1])))
    want = {k: np.asarray(v) for k, v in dataclasses.asdict(
        _jax_update_history(jcfg, _jstate(c))).items()}
    for k in ("hist_num", "hist_ring_num", "hist_t"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("hist_ssum", "hist_ring_ssum"):
        np.testing.assert_allclose(got[k], want[k], rtol=SUM_RTOL, atol=0,
                                   err_msg=k)
    for b, t in enumerate(hist_t):
        keep = np.arange(HL1) != t % HL1
        np.testing.assert_array_equal(got["hist_ring_ssum"][b][keep],
                                      ssum[b][keep])
    assert not np.array_equal(got["hist_ring_num"][0, 7],
                              got["hist_ring_num"][1, 7])


def test_shadow_insert_covers_every_slot_leaf():
    """G15's leaf list is SLOT_FILL's keys, each leaf made by one rule,
    within the kernel's argument block: a leaf added to the state later
    is written (a copy of the real's row) rather than skipped."""
    assert g15.LEAVES == tuple(SLOT_FILL)
    assert len(g15.LEAVES) <= g15.MAX_LEAVES
    assert set(g15.SET) <= set(SLOT_FILL) and set(g15.KIND) <= set(SLOT_FILL)
    assert not set(g15.SET) & set(g15.KIND)
    copied = {k for k in g15.LEAVES if g15.leaf_kind(k) == g15.K_COPY}
    assert copied == {"dis", "speed", "prev_drv", "route", "route_pos",
                      "enter_time", "enter_ll_time", "gap", "params",
                      "lc_last_t"}
    # a state with one more per-slot leaf is not refused by the rules
    assert g15.leaf_kind("a_new_leaf") == g15.K_COPY


def _duration_config(tmp_path):
    with open(CONFIG) as f:
        c = json.load(f)
    c.update(dir=FIX + "/", routerType="DURATION")
    path = tmp_path / "config_2x2_lc_duration.json"
    path.write_text(json.dumps(c))
    return str(path)


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """For each mode, one Engine on config_2x2_lc.json under DURATION on
    the CPU, its states after each of WARM steps (past the first shadows)
    in one pool of 2048 slots (the batch does not grow its pool), as a
    batch of len(WARM) distinct envs."""
    path = _duration_config(tmp_path_factory.mktemp("lc_batch"))
    out = {}
    for exact in (True, False):
        eng = Engine(path, exact=exact, backend="gen1", device="cpu",
                     max_vehicles=512, spawn_horizon=max(WARM) + STEPS + 16)
        snaps = []
        for t in range(1, max(WARM) + 1):
            eng.next_step()
            if t in WARM:
                snaps.append(eng.state)
        assert eng.cfg.lane_change and eng.cfg.track_history
        out[exact] = (eng, _stack(_same_pool(snaps, 2048)))
    return out


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_batched_lc_step_equals_single_env_steps(warm, exact):
    """B = 3 envs from distinct warm states with lane change and the
    DURATION history, batched, against each env stepped alone (a batch of
    one): every SimState leaf bit for bit after each of 40 steps, with
    shadows on the road."""
    eng, stb = warm[exact]
    cfg = dataclasses.replace(eng.cfg, max_vehicles=stb.active.shape[1])
    net, spawn = eng._net_dev, eng._spawn_dev
    step_b = make_batched_step(net, cfg, with_obs=False)
    # the batched step writes the state it is given (donated): it steps a
    # copy of the module's batch, and each env alone from its own copy
    stb = stb.map(torch.clone)
    singles = [stb.map(lambda t, b=b: t[b].clone()) for b in range(len(WARM))]
    shadow_steps = 0
    for t in range(STEPS):
        stb = step_b(stb, spawn)[0]
        singles = [ts.squeeze(ts.step(net, cfg, ts.lift(s), spawn))
                   for s in singles]
        bad = [(b, k) for b, s in enumerate(singles) for k in SIM_FIELDS
               if not _bitwise(getattr(stb, k)[b], getattr(s, k))]
        assert not bad, (t, bad[:5])
        shadow_steps += int((stb.is_shadow & stb.running).any(-1).sum())
    assert shadow_steps > 0
    assert int(stb.overflow.max()) == 0
    assert not torch.equal(stb.hist_ssum[0], stb.hist_ssum[1])
    assert stb.dis.dtype == (torch.float64 if exact else torch.float32)


@pytest.fixture(scope="module")
def jax_fast_batched(warm):
    """JAX's make_batched_step (fast mode, lane change, DURATION history)
    from the warm fast batch: each step's state before and after, as
    numpy leaves."""
    eng, stb = warm[False]
    cfg = dataclasses.replace(eng.cfg, max_vehicles=stb.active.shape[1])
    jnet = _net_device_arrays(eng.net, np.float32)
    jcfg = jstate.StepConfig(**dataclasses.asdict(cfg))
    jspawn = {k: jnp.asarray(v.numpy()) for k, v in eng._spawn_dev.items()}
    step_b = jbatch.make_batched_step(jnet, jcfg, with_obs=False)
    st = _jstate(sim_state_to_numpy(stb))
    pairs = []
    for _ in range(JAX_STEPS):
        prev = {k: np.asarray(getattr(st, k)) for k in SIM_FIELDS}
        st, _ = step_b(st, jspawn)
        pairs.append((prev, {k: np.asarray(getattr(st, k))
                             for k in SIM_FIELDS}))
    return dict(net=eng._net_dev, cfg=cfg, spawn=eng._spawn_dev,
                pairs=pairs)


def _finite_where_equal(mine, theirs):
    """Both leaf dicts with the infinities they share set to 0, so that
    _mismatches (which subtracts) reads them as equal (lc_lgap and lc_fgap
    hold +inf where there is no target leader or follower)."""
    a, b = dict(mine), dict(theirs)
    for k in SIM_FIELDS:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype.kind == "f" and x.shape == y.shape:
            same = np.isinf(x) & (x == y)
            a[k], b[k] = np.where(same, 0, x), np.where(same, 0, y)
    return a, b


def test_batched_fast_lc_step_matches_jax(jax_fast_batched):
    """The port's batched fast step with lane change and the history
    window from JAX's batched state against JAX's next state, each of 8
    steps: ints and bools exact, floats within 1e-5 of the leaf's
    scale."""
    d = jax_fast_batched
    step_b = make_batched_step(d["net"], d["cfg"], with_obs=False)
    bad = {}
    for t, (prev, want) in enumerate(d["pairs"]):
        got, _ = step_b(sim_state_from_numpy(prev, "cpu", torch.float32),
                        d["spawn"])
        diff = _mismatches(*_finite_where_equal(sim_state_to_numpy(got),
                                                want), F32_TOL)
        if diff:
            bad[t + 1] = diff
    assert not bad, f"first differing step {min(bad)}: {bad[min(bad)]}"
    last = d["pairs"][-1][1]
    assert (last["is_shadow"] & last["running"]).any()


def test_bench_gen1_layout_runs_lane_change_on_the_cpu(capsys):
    """tools/bench.py --layout gen1 on config_2x2_lc.json at B = 2 from an
    80-step warm-up: the JAX bench's keys, "lane_change": true, no
    overflow flag."""
    from cityflow_tpu_torch.tools import bench
    bench.main(["--layout", "gen1", "--config", CONFIG, "--batch", "2",
                "--steps", "4", "--window", "0", "--warmup", "80",
                "--max-vehicles", "512", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["layout"] == "gen1" and line["lane_change"] is True
    assert line["overflow_flags"] == 0
    assert line["batch"] == 2 and line["steps"] == 4
    assert line["device"] == "cpu" and line["vehicles_per_env"] > 0
