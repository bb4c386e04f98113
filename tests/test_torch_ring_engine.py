"""The port's ring-backed `Engine` (ring_backend.RingShell):
tests/test_ring_engine.py restated on the port, on config_4x4.json and
config_2x2_mixed.json (backend selection, the getters against the port's
gen-1 fast Engine, the control surface, reset, archives, reroutes, pushes,
replay lines, the cross-drivable leader), and held against the JAX
package's ring Engine: 100 steps in the tests/test_ring.py:_run_compare
sense, and an archive JAX's ring Engine dumped, loaded into the port's and
run on beside JAX's. The ring's DURATION history against gen-1 fast mode
is tests/test_router_duration.py::test_ring_backend_serves_duration on
config_2x2.json."""

import json
import math
import os

import numpy as np
import pytest
import torch

from cityflow_tpu.engine import Engine as JEngine

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.engine import Engine

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
TOL = 2e-3          # |dis|, |speed|: the _run_compare tolerance


def _fix(name):
    return os.path.join(FIX, name)


def _mk(cfg="config_4x4.json", **kw):
    return Engine(_fix(cfg), exact=False, device="cpu", **kw)


def _vehicles(eng):
    """{uid: (drivable, dis, speed)} of the running vehicles."""
    if eng._ring is not None:
        return ring_sim.fetch_vehicles(eng._ring.sim)
    c = eng._fetch()
    return {int(c["uid"][i]): (int(c["drv"][i]), float(c["dis"][i]),
                               float(c["speed"][i]))
            for i in np.nonzero(c["running"])[0]}


def _track(a, b, tol=TOL):
    """The _run_compare sense: the same vehicles on the same drivables,
    |dis| and |speed| within tol; returns the worst difference."""
    va, vb = _vehicles(a), _vehicles(b)
    assert set(va) == set(vb), f"vehicle sets differ ({len(va)}, {len(vb)})"
    worst = 0.0
    for u in va:
        assert va[u][0] == vb[u][0], (u, va[u], vb[u])
        worst = max(worst, abs(va[u][1] - vb[u][1]),
                    abs(va[u][2] - vb[u][2]))
    assert worst <= tol, worst
    return worst


def test_backend_selection():
    assert _mk()._ring is not None
    assert _mk(backend="gen1")._ring is None
    assert _mk(backend="ring")._ring is not None
    e = Engine(_fix("config_4x4.json"), device="cpu")
    assert e._ring is None and e.state.dis.dtype == torch.float64
    with pytest.raises(ValueError):
        Engine(_fix("config_4x4.json"), backend="ring", device="cpu")
    with pytest.raises(ValueError):
        _mk(backend="tpu")


@pytest.fixture(scope="module")
def ring_and_gen1():
    """The ring and gen-1 fast Engines on config_4x4.json, 90 steps,
    with the getters read every 10th step and the leaders every 5th from
    step 20."""
    r, g = _mk(), _mk(backend="gen1")
    reads, leaders = [], []
    for t in range(90):
        r.next_step()
        g.next_step()
        if t % 10 == 9:
            reads.append({e: dict(
                count=x.get_vehicle_count(), ids=sorted(x.get_vehicles()),
                lanes=x.get_lane_vehicle_count(),
                speed=x.get_vehicle_speed())
                for e, x in (("r", r), ("g", g))})
        if t >= 20 and t % 5 == 4:
            lane_of = {v: ln for ln, vs in r.get_lane_vehicles().items()
                       for v in vs}
            ids = sorted(set(r.get_vehicles()) & set(g.get_vehicles()))
            leaders.append([(v, r.get_leader(v), g.get_leader(v),
                             lane_of.get(v), lane_of.get(r.get_leader(v)))
                            for v in ids])
    return dict(r=r, g=g, reads=reads, leaders=leaders)


def test_ring_engine_matches_gen1_fast(ring_and_gen1):
    reads = ring_and_gen1["reads"]
    for rd in reads:
        a, b = rd["r"], rd["g"]
        assert a["count"] == b["count"] and a["ids"] == b["ids"]
        assert a["lanes"] == b["lanes"]
        for v in a["speed"]:
            assert abs(a["speed"][v] - b["speed"][v]) < 1e-3, v
    r, g = ring_and_gen1["r"], ring_and_gen1["g"]
    assert reads[-1]["r"]["count"] > 400
    assert abs(r.get_average_travel_time()
               - g.get_average_travel_time()) < 0.5
    assert sorted(r.get_vehicles(include_waiting=True)) \
        == sorted(g.get_vehicles(include_waiting=True))
    assert r.get_lane_waiting_vehicle_count() \
        == g.get_lane_waiting_vehicle_count()


def test_ring_engine_cross_drivable_leader(ring_and_gen1):
    """get_leader on the ring walks across the drivable boundary as the
    reference does (vehicle.cpp:157-196): equal to gen-1's leader for
    every vehicle, and some agreeing pairs span a lane / lanelink
    boundary."""
    checked = cross = 0
    for rows in ring_and_gen1["leaders"]:
        for vid, lr, lg, lane_v, lane_l in rows:
            assert lr == lg, (vid, lr, lg)
            checked += 1
            cross += bool(lr) and lane_v != lane_l
    assert checked > 50 and cross > 0


def test_ring_engine_mixed_templates():
    """Non-uniform templates on the ring Engine: selected, the getters
    agree with gen-1 fast mode, get_vehicle_info has each vehicle's
    template geometry."""
    r, g = _mk("config_2x2_mixed.json"), _mk("config_2x2_mixed.json",
                                              backend="gen1")
    assert r._ring is not None and not r._ring.sim.cfg.uniform
    assert r._ring.sim.cfg.TP == 3
    for t in range(60):
        r.next_step()
        g.next_step()
        if t % 20 == 19:
            assert sorted(r.get_vehicles()) == sorted(g.get_vehicles()), t
            assert r.get_lane_vehicle_count() == g.get_lane_vehicle_count()
    for v in r.get_vehicles():
        ir, ig = r.get_vehicle_info(v), g.get_vehicle_info(v)
        assert ir["drivable"] == ig["drivable"], v
        assert abs(float(ir["distance"]) - float(ig["distance"])) < TOL
    c = r._fetch()
    lens = {round(float(c["len"][i]), 3)
            for i in range(len(c["uid"])) if c["running"][i]}
    assert lens <= {5.0, 10.0, 4.0} and len(lens) > 1, lens


def test_ring_engine_control_surface():
    eng = _mk()
    for _ in range(30):
        eng.next_step()
    vid = eng.get_vehicles()[0]
    for _ in range(8):
        eng.set_vehicle_speed(vid, 1.0)
        eng.next_step()
        assert vid in eng.get_vehicle_speed()
    assert eng.get_vehicle_speed()[vid] <= 1.0 + 1e-6
    info = eng.get_vehicle_info(vid)
    assert info["running"] == "1" and "route" in info
    assert isinstance(eng.get_leader(vid), str)
    with pytest.raises(RuntimeError):
        eng.get_vehicle_info("nope_1")
    with pytest.raises(RuntimeError):
        eng.set_vehicle_speed("nope_1", 1.0)


def test_ring_engine_reset_reproducibility():
    eng = _mk()
    for _ in range(40):
        eng.next_step()
    a = (eng.get_current_time(), eng.get_vehicle_count(),
         eng.get_average_travel_time())
    eng.reset(seed=True)
    assert eng.get_current_time() == 0.0 and eng.get_vehicle_count() == 0
    for _ in range(40):
        eng.next_step()
    assert (eng.get_current_time(), eng.get_vehicle_count(),
            eng.get_average_travel_time()) == a


def test_ring_engine_archive_roundtrip(tmp_path):
    eng = _mk()
    for _ in range(30):
        eng.next_step()
    path = str(tmp_path / "ring_arch.json")
    eng.snapshot().dump(path)
    for _ in range(10):
        eng.next_step()
    after = (eng.get_vehicle_count(), eng.get_average_travel_time(),
             sorted(_vehicles(eng).items()))
    eng.load_from_file(path)
    assert eng.get_current_time() == 30.0
    for _ in range(10):
        eng.next_step()
    assert (eng.get_vehicle_count(), eng.get_average_travel_time(),
            sorted(_vehicles(eng).items())) == after
    # an archive of one backend does not load into the other
    with pytest.raises(RuntimeError, match="layout mismatch"):
        _mk(backend="gen1").load_from_file(path)


def test_ring_engine_snapshot_is_not_reached_by_later_writes():
    """set_tl_phase, set_vehicle_speed and set_vehicle_route after a
    snapshot write new tensors: loading the snapshot gives its state."""
    path = _fix("config_4x4_rl.json")
    eng = Engine(path, exact=False, device="cpu")
    for _ in range(25):
        eng.next_step()
    snap = eng.snapshot()
    before = {k: v.clone() for k, v in snap.state.leaves().items()}
    inter = next(i.id for i in eng.net.host.net.intersections
                 if not i.virtual)
    eng.set_tl_phase(inter, 3)
    vid = eng.get_vehicles()[0]
    eng.set_vehicle_speed(vid, 0.5)
    rerouted = False
    for v in eng.get_vehicles():
        info = eng.get_vehicle_info(v)
        rest = info["route"].split()
        if info.get("road") and len(rest) >= 2 and \
                eng.set_vehicle_route(v, [rest[1]]):
            rerouted = True
            break
    assert rerouted
    changed = [k for k, v in eng._ring.sim.state.leaves().items()
               if not torch.equal(v, before[k])]
    assert {"phase", "l_custom", "l_hascustom", "l_route"} <= set(changed)
    for k, v in snap.state.leaves().items():
        assert torch.equal(v, before[k]), k
    eng.load(snap)
    for k, v in eng._ring.sim.state.leaves().items():
        assert torch.equal(v, before[k]), k


def test_ring_engine_grows_full_rings():
    """Rings too small for the traffic (4 lane and 3 link slots) grow on
    OV_SLOTS and the step runs again from the state before it: the
    trajectory equals that of rings big enough from the start; a snapshot
    taken before the growth loads back with its own ring sizes."""
    big, small = _mk(), _mk()
    small._ring.sim = ring_sim.build_sim(small.net, horizon=small._ring.horizon,
                                         sl=4, sk=3, device="cpu")
    ring_sim.rebuild_queues(small._ring.sim, small._spawn, small._ring.horizon)
    big.next_step()
    small.next_step()
    snaps = (big.snapshot(), small.snapshot())
    for _ in range(119):
        big.next_step()
        small.next_step()
    assert small._ring.growths >= 2 and big._ring.growths == 0
    assert small._ring.sim.cfg.SL > 4 and small._ring.sim.cfg.SK > 3
    assert _vehicles(small) == _vehicles(big)
    assert len(_vehicles(big)) > 500
    big.load(snaps[0])
    small.load(snaps[1])
    assert (small._ring.sim.cfg.SL, small._ring.sim.cfg.SK) == (4, 3)
    for _ in range(40):
        big.next_step()
        small.next_step()
    assert _vehicles(small) == _vehicles(big)


def test_ring_engine_set_route():
    eng = _mk()
    for _ in range(20):
        eng.next_step()
    done = 0
    for v in eng.get_vehicles():
        info = eng.get_vehicle_info(v)
        rest = info["route"].split()
        if not info.get("road") or len(rest) < 2:
            continue
        if eng.set_vehicle_route(v, [rest[1]]):
            assert eng.get_vehicle_info(v)["route"].split()[-1] == rest[1]
            done += 1
            if done == 3:
                break
    assert done == 3
    for _ in range(5):
        eng.next_step()
    assert eng.get_vehicle_count() > 0


def test_ring_engine_push_vehicle():
    eng = _mk()
    for _ in range(5):
        eng.next_step()
    p = eng._ring.sim.meta.param_row
    info = {"speed": float(p[0]), "length": float(p[1]),
            "width": float(p[2]), "maxPosAcc": float(p[3]),
            "maxNegAcc": float(p[4]), "usualPosAcc": float(p[5]),
            "usualNegAcc": float(p[6]), "minGap": float(p[7]),
            "maxSpeed": float(p[8]), "headwayTime": float(p[9])}
    roads = [r.id for r in eng.net.host.flows[0].route[:2]]
    eng.push_vehicle(info, roads)
    for _ in range(12):
        eng.next_step()
    assert "manually_pushed_0" in eng.get_vehicles(include_waiting=True)
    # a template the ring does not hold is refused, not run wrong
    with pytest.raises(ValueError, match="backend='gen1'"):
        eng.push_vehicle(dict(info, maxSpeed=3.33), roads)


def test_ring_engine_replay_log(tmp_path):
    with open(_fix("config_4x4.json")) as f:
        cfg = json.load(f)
    cfg.update(saveReplay=True, roadnetLogFile=str(tmp_path / "rn.json"),
               replayLogFile=str(tmp_path / "rp.txt"))
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    eng = Engine(str(p), exact=False, device="cpu")
    assert eng._ring is not None
    for _ in range(12):
        eng.next_step()
    lines = open(str(tmp_path / "rp.txt")).read().strip().split("\n")
    assert len(lines) == 12
    veh_part, _ = lines[-1].split(";")
    toks = [x for x in veh_part.split(",") if x.strip()]
    assert len(toks) == eng.get_vehicle_count()
    assert len(toks[0].split()) == 7      # x y angle id lcDir len width
    assert json.load(open(str(tmp_path / "rn.json")))["static"]["nodes"]


@pytest.mark.parametrize("config", ["config_4x4.json",
                                    "config_2x2_mixed.json"])
def test_ring_engine_tracks_jax_ring_engine(config):
    """The port's ring Engine against the JAX package's Engine(exact=False)
    for 100 steps, every 10th: the same vehicles on the same drivables,
    |dis| and |speed| within 2e-3, the same finished count."""
    j = JEngine(_fix(config), exact=False)
    p = _mk(config)
    assert j._ring is not None and p._ring is not None
    for t in range(1, 101):
        j.next_step()
        p.next_step()
        if t % 10 == 0:
            _track(p, _JaxView(j))
    assert p._ring.stats()[1] == int(j._ring.sim.state.finished_cnt)
    assert p.get_average_travel_time() == pytest.approx(
        j.get_average_travel_time(), rel=1e-4)


class _JaxView:
    """JAX's ring Engine seen through `_vehicles`."""

    def __init__(self, eng):
        self._ring = None
        self._eng = eng

    def _fetch(self):
        return self._eng._fetch()


def test_jax_ring_archive_loads_and_tracks_jax(tmp_path):
    """An archive the JAX package's ring Engine dumped at step 30 loads
    into the port's ring Engine (the state carried across), which then
    tracks JAX's for 40 steps."""
    path = _fix("config_4x4.json")
    j = JEngine(path, exact=False)
    for _ in range(30):
        j.next_step()
    arch = str(tmp_path / "jax_ring.json")
    j.snapshot().dump(arch)
    p = _mk()
    p.load_from_file(arch)
    assert p.get_current_time() == 30.0
    _track(p, _JaxView(j), tol=0.0)
    for t in range(40):
        j.next_step()
        p.next_step()
        if t % 10 == 9:
            _track(p, _JaxView(j))
    assert sorted(p.get_vehicles(include_waiting=True)) \
        == sorted(j.get_vehicles(include_waiting=True))


def test_ring_engine_lane_change_view():
    """The ring Engine with lane change (config_1x1s_lc.json, 80 steps):
    the host view pairs each changing real with its shadow (the same uid,
    the other shadow flag, partners of each other); get_vehicles leaves
    the shadows out; a shadow carries its real's uid on the ring (the JAX
    package's convention there), so get_lane_vehicles lists its real's id
    on the shadow's lane as well."""
    eng = Engine(_fix("config_1x1s_lc.json"), exact=False, device="cpu")
    assert eng._ring is not None and eng._ring.sim.cfg.lane_change
    pairs = 0
    for _ in range(80):
        eng.next_step()
        c = eng._fetch()
        part = c["partner"]
        for i in np.nonzero(part >= 0)[0]:
            j = part[i]
            assert part[j] == i and c["uid"][i] == c["uid"][j]
            assert c["is_shadow"][i] != c["is_shadow"][j]
            pairs += 1
        ids = eng.get_vehicles()
        assert len(ids) == len(set(ids))
        assert len(ids) == int((c["running"] & ~c["is_shadow"]).sum())
        listed = [v for vs in eng.get_lane_vehicles().values() for v in vs]
        assert len(listed) - len(set(listed)) == int(c["is_shadow"].sum())
        assert set(listed) <= set(ids)
    assert pairs > 20


@pytest.mark.slow
def test_ring_engine_lane_change_view_matches_jax():
    """The same run against the JAX package's ring Engine: every key of
    the host view (the pairs, offsets, gaps and leaders included) equal
    for 80 steps, floats within 1e-4 (JAX's first lane-change step jits
    for ~80 s)."""
    j = JEngine(_fix("config_1x1s_lc.json"), exact=False)
    p = Engine(_fix("config_1x1s_lc.json"), exact=False, device="cpu")
    shadows = 0
    for t in range(80):
        j.next_step()
        p.next_step()
        fj, fp = j._fetch(), p._fetch()
        assert set(fj) == set(fp)
        for k in fj:
            a, b = np.asarray(fp[k]), np.asarray(fj[k])
            assert a.shape == b.shape, (t, k)
            if a.dtype.kind == "f" or b.dtype.kind == "f":
                np.testing.assert_allclose(a.astype(float), b.astype(float),
                                           rtol=0, atol=1e-4, err_msg=k)
            else:
                np.testing.assert_array_equal(a.astype(np.int64),
                                              b.astype(np.int64), err_msg=k)
        shadows += int(fp["is_shadow"].sum())
    assert shadows > 0


def test_ring_history_matches_gen1_fast(tmp_path):
    """routerType DURATION on the ring (its h_* window) against gen-1
    fast mode on config_2x2.json after 40 steps: per lane the window
    count equal and the mean speed within 2e-3; the road durations the
    router reads likewise; a reroute on the ring reads them."""
    with open(_fix("config_2x2.json")) as f:
        cfg = json.load(f)
    cfg.update(dir=FIX + "/", routerType="DURATION")
    p = tmp_path / "config_duration.json"
    p.write_text(json.dumps(cfg))
    e1 = Engine(str(p), exact=False, backend="gen1", device="cpu")
    e2 = Engine(str(p), exact=False, backend="ring", device="cpu")
    assert e2._ring.sim.cfg.track_history
    for _ in range(40):
        e1.next_step()
        e2.next_step()
    h1, h2 = e1.get_lane_history(), e2.get_lane_history()
    assert set(h1) == set(h2)
    assert sum(n for n, _ in h1.values()) > 100
    for lid in h1:
        assert h1[lid][0] == h2[lid][0], lid
        assert abs(h1[lid][1] - h2[lid][1]) <= 2e-3 * max(abs(h1[lid][1]),
                                                          1.0), lid
    d1, d2 = e1._road_durations(), e2._road_durations()
    assert set(d1) == set(d2)
    for ri in d1:
        if d1[ri] < 0 or math.isinf(d1[ri]):
            assert d1[ri] == d2[ri]
        else:
            assert abs(d1[ri] - d2[ri]) <= 2e-3 * max(abs(d1[ri]), 1.0)
    for v in e2.get_vehicles()[:8]:
        info = e2.get_vehicle_info(v)
        if info.get("road"):
            e2.set_vehicle_route(v, [info["road"]])
    e2.next_step()
    assert e2.get_vehicle_count() > 0
