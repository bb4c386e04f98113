"""The port's gen-1 Engine around its step: the getters against the JAX
package's Engine (one run of 100 steps on config_2x2.json, its step jitted
once), pushed vehicles and reroutes against the same, capacity growth,
snapshots and archives (after reseeds, pushes and resets too), reset, and
the options it refuses."""

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


@pytest.mark.parametrize("what", ["exact=False", "backend=ring"])
def test_unported_engine_options_raise(what):
    """The options the Engine refuses, as the JAX package's does: with
    exact=False a backend it does not know, and backend="ring" in exact
    mode (the ring runs float32 only). (Named for when exact=False and
    the ring backend were not ported; both run now, in
    test_torch_gen1_fast.py and test_torch_ring_engine.py.)"""
    kw = dict(device="cpu")
    if what == "exact=False":
        kw.update(exact=False, backend="tpu")
        match = "unknown backend"
    else:
        kw["backend"] = "ring"
        match = "requires exact=False"
    with pytest.raises(ValueError, match=match):
        Engine(CONFIG, **kw)


def _push_and_route(eng):
    """tests/test_api.py:71-99: a pushed vehicle with its own max speed,
    then the first compatible reroute of a vehicle on road_0_1_0; the
    getters at each stop."""
    out = []
    for _ in range(5):
        eng.next_step()
    eng.push_vehicle({"maxSpeed": 10.0}, ["road_0_1_0", "road_1_1_0"])
    for _ in range(8):
        eng.next_step()
    out.append({k: g(eng) for k, g in GETTERS.items()})
    cands = [v for v in eng.get_vehicles()
             if eng.get_vehicle_info(v).get("road") == "road_0_1_0"]
    hit = None
    for v in cands:
        for target in ("road_1_1_0", "road_1_1_1", "road_1_1_3"):
            if eng.set_vehicle_route(v, [target]):
                hit = (v, target)
                break
        if hit:
            break
    out.append(dict(hit=hit, bad=eng.set_vehicle_route(hit[0],
                                                      ["no_such_road"]),
                    info={k: g(eng) for k, g in GETTERS.items()}["info"]))
    for _ in range(10):
        eng.next_step()
    out.append({k: g(eng) for k, g in GETTERS.items()})
    return out


def test_push_vehicle_and_reroute_match_jax_engine():
    from cityflow_tpu.engine import Engine as JaxEngine
    want = _push_and_route(JaxEngine(CONFIG))
    got = _push_and_route(Engine(CONFIG, device="cpu"))
    assert "manually_pushed_0" in got[0]["vehicles_waiting"]
    info = got[0]["info"]["manually_pushed_0"]
    assert info["route"].split() == ["road_0_1_0", "road_1_1_0"]
    hit = got[1]["hit"]
    assert hit is not None and got[1]["bad"] is False
    assert got[1]["info"][hit[0]]["route"].split()[-1] == hit[1]
    for stop, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"stop {stop} differs"


def _metrics_run(eng, n):
    """tests/test_archive.py's record: lane counts, average travel time,
    vehicle count, after each of n steps."""
    out = []
    for _ in range(n):
        eng.next_step()
        out.append((eng.get_lane_vehicle_count(),
                    eng.get_average_travel_time(), eng.get_vehicle_count()))
    return out


def test_cross_engine_restore_after_reseed_and_push(tmp_path):
    """A dump taken after a mid-run set_random_seed and push_vehicle
    restores into a fresh Engine and replays the same future
    (tests/test_archive.py:67-94)."""
    eng = Engine(CONFIG, device="cpu")
    _metrics_run(eng, 20)
    eng.set_random_seed(2023)
    _metrics_run(eng, 10)
    eng.push_vehicle({"maxSpeed": 12.0}, ["road_0_1_0", "road_1_1_0"])
    _metrics_run(eng, 5)
    path = str(tmp_path / "arch_cross.json")
    eng.snapshot().dump(path)
    rec1 = _metrics_run(eng, 40)
    ids1 = eng.get_vehicles(include_waiting=True)
    fresh = Engine(CONFIG, device="cpu")
    fresh.load_from_file(path)
    assert _metrics_run(fresh, 40) == rec1
    assert fresh.get_vehicles(include_waiting=True) == ids1
    assert "manually_pushed_0" in ids1 or eng.state.finished_cnt > 0


def test_push_after_continuing_reset(tmp_path):
    """push_vehicle after reset(False): the RNG stream continues across
    the reset and the push interleaves into it; a dump round-trips
    (tests/test_archive.py:97-119)."""
    eng = Engine(CONFIG, device="cpu")
    _metrics_run(eng, 25)
    eng.reset(False)
    eng.push_vehicle({}, ["road_0_1_0", "road_1_1_0"])
    _metrics_run(eng, 30)
    ids1 = eng.get_vehicles(include_waiting=True)
    path = str(tmp_path / "arch_reset.json")
    eng.snapshot().dump(path)
    fresh = Engine(CONFIG, device="cpu")
    fresh.load_from_file(path)
    assert _metrics_run(fresh, 20) == _metrics_run(eng, 20)
    assert "manually_pushed_0" in ids1
