"""The DURATION router in the port's gen-1 Engine: G5 hist_window (plain)
against the JAX package's update_history, the Engine's lane history
against the reference golden and against the getters it summarises, and
reroutes that read it (tests/test_router_duration.py's checks, on the
self-contained config_2x2.json)."""

import dataclasses
import gzip
import json
import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cityflow_tpu.core import state as jstate
from cityflow_tpu.core import step as js

from cityflow_tpu_torch.carry import sim_state_from_numpy, sim_state_to_numpy
from cityflow_tpu_torch.compiler import flows as flows_mod
from cityflow_tpu_torch.core import step as ts
from cityflow_tpu_torch.engine import Engine

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
# the speed sums: G5 adds each lane's vehicles in G1's order, XLA's
# scatter-add in its own, so the two may differ by the rounding of the
# adds (a few ulp of a sum of at most a few dozen speeds)
SUM_RTOL = 1e-12


def _config(tmp_path, router="DURATION", **over):
    with open(os.path.join(FIX, "config_2x2.json")) as f:
        cfg = json.load(f)
    cfg.update(over, dir=FIX + "/", routerType=router)
    path = tmp_path / f"config_{router.lower()}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def duration_config(tmp_path_factory):
    return _config(tmp_path_factory.mktemp("duration"))


@partial(jax.jit, static_argnums=(0,))
def _jax_update_history(cfg, st):
    return js.update_history(cfg, st)


@pytest.mark.parametrize("hist_t", [7, 240, 241, 700],
                         ids=["filling", "last-free-row", "wrap", "full"])
def test_hist_window_matches_jax_update_history(duration_config, hist_t):
    """Seeded window contents (counts and speed sums per ring row, sums
    that agree with them) on a state with ~100 running vehicles, before
    and after the 241-row ring wraps: the ring rows and the counts
    exact, the speed sums within SUM_RTOL."""
    eng = Engine(duration_config, device="cpu")
    for _ in range(60):
        eng.next_step()
    rng = np.random.default_rng(hist_t)
    c = sim_state_to_numpy(eng.state)
    HL1, L = c["hist_ring_num"].shape
    rows = min(hist_t, HL1)
    num = np.zeros((HL1, L))
    num[:rows] = rng.integers(0, 12, (rows, L))
    ssum = num * rng.uniform(0.0, 16.7, (HL1, L))
    c.update(hist_ring_num=num, hist_ring_ssum=ssum, hist_num=num.sum(0),
             hist_ssum=ssum.sum(0), hist_t=np.int32(hist_t))
    st = sim_state_from_numpy(c, "cpu")
    assert int(st.running.sum()) > 80
    arr = ts.arrangement(eng._net_dev, eng.cfg, st.running, st.drv, st.dis,
                         st.list_seq)
    got = sim_state_to_numpy(ts.update_history(eng.cfg, st, arr))
    jst = jstate.SimState(**{k: jnp.asarray(v) for k, v in c.items()})
    jcfg = jstate.StepConfig(**dataclasses.asdict(eng.cfg))
    want = {k: np.asarray(v) for k, v in dataclasses.asdict(
        _jax_update_history(jcfg, jst)).items()}
    for k in ("hist_num", "hist_ring_num", "hist_t"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    slot = hist_t % HL1
    for k in ("hist_ssum", "hist_ring_ssum"):
        np.testing.assert_allclose(got[k], want[k], rtol=SUM_RTOL, atol=0,
                                   err_msg=k)
    # every other ring row untouched
    keep = np.arange(HL1) != slot
    np.testing.assert_array_equal(got["hist_ring_ssum"][keep], ssum[keep])
    assert got["hist_ring_num"][slot].sum() == int(
        (c["running"] & (c["drv"] < L)).sum())


def test_lane_history_matches_the_reference_golden(duration_config):
    """Road::getAverageDuration per road and step against the unmodified
    reference (history_2x2_40): window vehicle sums equal, durations
    within 1e-9 relative."""
    eng = Engine(duration_config, device="cpu")
    with gzip.open(os.path.join(HERE, "goldens", "history_2x2_40.jsonl.gz"),
                   "rt") as f:
        gold = [json.loads(line) for line in f]
    road_index = {r.id: r.index for r in eng.net.host.net.roads}
    checked = 0
    for rec in gold:
        eng.next_step()
        durs = eng._road_durations()
        nums, _ = eng._lane_history_np()
        for rid, ref_num, ref_dur in rec["roads"]:
            ri = road_index[rid]
            road = eng.net.host.net.roads[ri]
            my_num = sum(int(nums[lane.index]) for lane in road.lanes)
            assert my_num == ref_num, (rec["t"], rid, my_num, ref_num)
            my_dur = durs[ri]
            if ref_dur < 0:
                assert my_dur < 0, (rec["t"], rid, my_dur)
            elif math.isinf(ref_dur):
                assert math.isinf(my_dur)
            else:
                assert abs(my_dur - ref_dur) <= 1e-9 * max(abs(ref_dur), 1), \
                    (rec["t"], rid, my_dur, ref_dur)
                checked += 1
    assert checked > 100


def test_lane_history_matches_the_getters(duration_config):
    """get_lane_history against Lane::updateHistory replayed from the
    per-step lane vehicles and speeds the API reports."""
    eng = Engine(duration_config, device="cpu")
    ids = eng.net.host.lane_ids
    entries = {lid: [] for lid in ids}
    for _ in range(40):
        eng.next_step()
        lv = eng.get_lane_vehicles()
        speeds = eng.get_vehicle_speed()
        for lid in ids:
            vs = lv.get(lid, [])
            entries[lid].append((len(vs), sum(speeds[v] for v in vs)))
    hist = eng.get_lane_history()
    assert set(hist) == set(ids)
    busy = 0
    for lid in ids:
        num = sum(n for n, _ in entries[lid][-241:])
        ssum = sum(s for _, s in entries[lid][-241:])
        got_n, got_avg = hist[lid]
        assert got_n == num, (lid, got_n, num)
        if num:
            busy += 1
            assert abs(got_avg - ssum / num) < 1e-9
    assert busy > 10
    with pytest.raises(RuntimeError, match="DURATION"):
        Engine(os.path.join(FIX, "config_2x2.json"),
               device="cpu").get_lane_history()


def _road_costs(eng, max_speed):
    """Road costs recomputed from get_lane_history: the reference's
    getAverageDuration (window-count-weighted average speed per road),
    through the same cost function as the router."""
    hist = eng.get_lane_history()
    durs = {}
    for road in eng.net.host.net.roads:
        n = sum(hist[eng.net.host.lane_ids[lane.index]][0]
                for lane in road.lanes)
        s = sum(hist[eng.net.host.lane_ids[lane.index]][0]
                * hist[eng.net.host.lane_ids[lane.index]][1]
                for lane in road.lanes)
        durs[road.index] = (-1.0 if n <= 0 else
                            flows_mod.road_average_length(road) / (s / n))
    return flows_mod.duration_cost_fn(durs, max_speed)


def test_reroutes_follow_the_router_cost(tmp_path):
    """set_vehicle_route under DURATION and under LENGTH: every accepted
    reroute is Dijkstra's route under that engine's road costs (under
    DURATION from the live lane history), and a vehicle not found or an
    unknown road is refused."""
    engines = {r: Engine(_config(tmp_path, r), device="cpu")
               for r in ("DURATION", "LENGTH")}
    far = ("road_2_1_2", "road_1_0_1", "road_0_1_0", "road_1_2_3")
    moved = {}
    for router, eng in engines.items():
        for _ in range(30):
            eng.next_step()
        host = eng.net.host
        moved[router] = []
        for vid in eng.get_vehicles()[:40]:
            info = eng.get_vehicle_info(vid)
            if "road" not in info:
                continue
            for target in far:
                if target == info["road"]:
                    continue
                slot = eng._id_to_slot(vid)
                max_spd = float(eng.state.params[slot, 8])
                cost = (_road_costs(eng, max_spd) if router == "DURATION"
                        else flows_mod.length_cost)
                want = flows_mod.update_shortest_path(
                    host.net, [host.net.road_map[info["road"]],
                               host.net.road_map[target]], cost=cost)
                if eng.set_vehicle_route(vid, [target]):
                    got = eng.get_vehicle_info(vid)["route"].split()
                    assert got == [r.id for r in want], (router, vid, target)
                    moved[router].append((vid, target, tuple(got)))
                    break
        assert len(moved[router]) >= 5, router
        assert not eng.set_vehicle_route("no_such_vehicle", [far[0]])
        assert not eng.set_vehicle_route(moved[router][0][0], ["no_road"])
        for _ in range(10):
            eng.next_step()
        assert eng.get_vehicle_count() > 0
    assert engines["DURATION"]._road_durations()
    assert not engines["LENGTH"]._road_durations()
