"""The port's gen-1 Engine around its step: the getters against the JAX
package's Engine (one run of 100 steps on config_2x2.json, its step jitted
once), capacity growth, snapshots and archives, reset, and the parts not
ported yet, which raise NotImplementedError naming ROADMAP.md."""

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from golden_util import engine_step_record  # noqa: E402

from cityflow_tpu_torch.engine import Engine  # noqa: E402

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
CONFIG = os.path.join(FIX, "config_2x2.json")

GETTERS = {
    "time": lambda e: e.get_current_time(),
    "count": lambda e: e.get_vehicle_count(),
    "vehicles": lambda e: e.get_vehicles(),
    "vehicles_waiting": lambda e: e.get_vehicles(include_waiting=True),
    "lane_count": lambda e: e.get_lane_vehicle_count(),
    "lane_waiting": lambda e: e.get_lane_waiting_vehicle_count(),
    "lane_vehicles": lambda e: e.get_lane_vehicles(),
    "speed": lambda e: e.get_vehicle_speed(),
    "distance": lambda e: e.get_vehicle_distance(),
    "travel_time": lambda e: e.get_average_travel_time(),
    "leader": lambda e: {v: e.get_leader(v) for v in e.get_vehicles()},
    "info": lambda e: {v: e.get_vehicle_info(v)
                       for v in e.get_vehicles(include_waiting=True)},
}


def _drive(eng):
    """60 steps, a custom speed for one vehicle, 10 steps, reset with the
    RNG stream going on, 30 steps: the getters at each stop."""
    out = []
    for _ in range(60):
        eng.next_step()
    out.append({k: g(eng) for k, g in GETTERS.items()})
    eng.set_vehicle_speed(eng.get_vehicles()[3], 2.5)
    for _ in range(10):
        eng.next_step()
    out.append({k: g(eng) for k, g in GETTERS.items()})
    eng.reset()
    for _ in range(30):
        eng.next_step()
    out.append({k: g(eng) for k, g in GETTERS.items()})
    return out


@pytest.fixture(scope="module")
def both():
    from cityflow_tpu.engine import Engine as JaxEngine
    return _drive(JaxEngine(CONFIG)), _drive(Engine(CONFIG, device="cpu"))


@pytest.mark.parametrize("getter", sorted(GETTERS))
def test_getters_match_jax_engine(both, getter):
    jax_out, port_out = both
    for stop, (j, p) in enumerate(zip(jax_out, port_out)):
        assert p[getter] == j[getter], f"{getter} differs at stop {stop}"
    assert port_out[0]["count"] > 50


def _records(eng, n):
    out = []
    for _ in range(n):
        eng.next_step()
        out.append(engine_step_record(eng))
    return out


def test_growth_run_equals_a_run_without_growth():
    small = Engine(CONFIG, device="cpu", max_vehicles=64)
    big = Engine(CONFIG, device="cpu")
    assert _records(small, 120) == _records(big, 120)
    assert small.growths >= 2 and small.cfg.max_vehicles >= 256
    assert big.growths == 0
    assert small.get_average_travel_time() == big.get_average_travel_time()


def test_snapshot_load_reproduces_the_trajectory():
    eng = Engine(CONFIG, device="cpu")
    _records(eng, 40)
    snap = eng.snapshot()
    dis0 = snap.state.dis.clone()
    first = _records(eng, 20)
    assert torch.equal(snap.state.dis, dis0), "stepping wrote the snapshot"
    eng.load(snap)
    assert eng.get_current_time() == 40.0
    assert _records(eng, 20) == first


def test_archive_file_round_trip_into_a_fresh_engine(tmp_path):
    eng = Engine(CONFIG, device="cpu", max_vehicles=64)
    _records(eng, 80)
    assert eng.growths > 0
    path = str(tmp_path / "archive.json")
    eng.snapshot().dump(path)
    want = _records(eng, 20)
    fresh = Engine(CONFIG, device="cpu")
    fresh.load_from_file(path)
    assert fresh.cfg.max_vehicles == eng.cfg.max_vehicles
    assert fresh.get_current_time() == 80.0
    assert _records(fresh, 20) == want


def test_reset_with_seed_reproduces_a_fresh_run():
    eng = Engine(CONFIG, device="cpu")
    want = _records(eng, 50)
    eng.reset(seed=True)
    assert eng.get_current_time() == 0.0 and eng.get_vehicle_count() == 0
    assert _records(eng, 50) == want


def _config(tmp_path, **over):
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg.update(over, dir=FIX + "/")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("what", [
    "exact=False", "backend=ring", "laneChange", "DURATION", "saveReplay"])
def test_unported_engine_options_raise(tmp_path, what):
    kw = dict(device="cpu")
    path = CONFIG
    if what == "exact=False":
        kw["exact"] = False
    elif what == "backend=ring":
        kw["backend"] = "ring"
    elif what == "laneChange":
        path = os.path.join(FIX, "config_2x2_lc.json")
    elif what == "DURATION":
        path = _config(tmp_path, routerType="DURATION")
    else:
        path = _config(tmp_path, saveReplay=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Engine(path, **kw)


@pytest.fixture(scope="module")
def engine():
    return Engine(CONFIG, device="cpu")


@pytest.mark.parametrize("call", [
    lambda e: e.push_vehicle({}, ["road_0_1_0"]),
    lambda e: e.set_vehicle_route("flow_0_0", ["road_0_1_0"]),
    lambda e: e.get_lane_history(),
    lambda e: e.set_save_replay(True),
    lambda e: e.set_replay_file("replay.txt"),
], ids=["push_vehicle", "set_vehicle_route", "get_lane_history",
        "set_save_replay", "set_replay_file"])
def test_unported_engine_calls_raise(engine, call):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call(engine)
