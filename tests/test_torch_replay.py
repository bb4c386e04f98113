"""Replay files of the port's gen-1 Engine against the reference
(tests/test_replay.py's checks on the self-contained 2x2 fixture): the
per-step lines against replay_2x2_60 (the unmodified reference's
replayLogFile), the intersection outlines against outline_2x2.json, the
roadnet log's shape, switching files mid-run, and the calls refused
without saveReplay in the config."""

import gzip
import json
import os

import numpy as np
import torch

from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.engine import Engine
from cityflow_tpu_torch.replay import _outline

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")


def _config(tmp_path, **over):
    cfg = {"interval": 1.0, "seed": 0, "dir": FIX + "/",
           "roadnetFile": "roadnet_2x2.json", "flowFile": "flow_2x2.json",
           "rlTrafficLight": False, "laneChange": False, "saveReplay": True,
           "roadnetLogFile": str(tmp_path / "rlog.json"),
           "replayLogFile": str(tmp_path / "replay.txt")}
    cfg.update(over)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _parse(line):
    veh_part, road_part = line.split(";", 1)
    vehs = {}
    for rec in veh_part.split(","):
        if rec.strip():
            x, y, ang, vid, lc, ln, w = rec.split()
            vehs[vid] = (float(x), float(y), float(ang), int(lc), float(ln),
                         float(w))
    roads = {}
    for rec in road_part.split(","):
        if rec.strip():
            parts = rec.split()
            roads[parts[0]] = parts[1:]
    return vehs, roads


def test_replay_lines_match_the_reference(tmp_path):
    """Same vehicles, positions and angles within 1e-6, the same lcDir,
    length and width, identical signal sections, for 60 steps."""
    eng = Engine(_config(tmp_path), device="cpu")
    for _ in range(60):
        eng.next_step()
    eng.set_save_replay(False)
    mine = (tmp_path / "replay.txt").read_text().splitlines()
    with gzip.open(os.path.join(HERE, "goldens", "replay_2x2_60.txt.gz"),
                   "rt") as f:
        ref = f.read().splitlines()
    assert len(mine) == len(ref) == 60
    seen = 0
    for t, (lm, lr) in enumerate(zip(mine, ref), 1):
        vm, rm = _parse(lm)
        vr, rr = _parse(lr)
        assert set(vm) == set(vr), (t, set(vm) ^ set(vr))
        for vid in vr:
            a, b = vm[vid], vr[vid]
            assert all(abs(x - y) <= 1e-6 for x, y in zip(a[:3], b[:3])), \
                (t, vid, a, b)
            assert a[3:] == b[3:], (t, vid, a, b)
        assert rm == rr, t
        seen += len(vr)
    assert seen > 1000


def test_outlines_match_the_reference_hull():
    """Intersection::getOutline against the reference's roadnet log, up
    to a cyclic rotation of the polygon."""
    net = compile_scenario(os.path.join(FIX, "config_2x2.json"))
    with open(os.path.join(HERE, "goldens", "outline_2x2.json")) as f:
        gold = json.load(f)
    for inter in net.host.net.intersections:
        ours = [tuple(p) for p in _outline(inter)]
        ref = gold[inter.id]
        ref_pts = [tuple(ref[i:i + 2]) for i in range(0, len(ref), 2)]
        assert len(ours) == len(ref_pts), inter.id
        assert any(np.allclose(np.asarray(ref_pts[r:] + ref_pts[:r]),
                               np.asarray(ours), atol=1e-6)
                   for r in range(len(ref_pts))), inter.id


def test_roadnet_log_and_switching_files(tmp_path):
    """The roadnet log's nodes and edges, one line per step in the record
    grammar, a new file mid-run, and set_save_replay(False) stopping it."""
    eng = Engine(_config(tmp_path), device="cpu")
    for _ in range(20):
        eng.next_step()
    static = json.loads((tmp_path / "rlog.json").read_text())["static"]
    assert {"nodes", "edges"} <= set(static)
    assert len(static["nodes"]) == len(eng.net.host.net.intersections)
    assert all({"id", "points", "nLane", "laneWidths"} <= set(e)
               for e in static["edges"])
    lines = (tmp_path / "replay.txt").read_text().splitlines()
    assert len(lines) == 20
    vehs, roads = _parse(lines[-1])
    assert vehs and roads
    assert all(t in ("g", "r", "i") for seg in roads.values() for t in seg)
    eng.set_replay_file(str(tmp_path / "replay2.txt"))
    eng.next_step()
    assert len((tmp_path / "replay2.txt").read_text().splitlines()) == 1
    eng.set_save_replay(False)
    eng.next_step()
    assert len((tmp_path / "replay2.txt").read_text().splitlines()) == 1
    eng.set_save_replay(True)
    eng.next_step()
    assert len((tmp_path / "replay2.txt").read_text().splitlines()) == 2


def test_replay_calls_without_save_replay_only_warn(tmp_path, capsys):
    eng = Engine(_config(tmp_path, saveReplay=False), device="cpu")
    eng.set_save_replay(True)
    eng.set_replay_file(str(tmp_path / "other.txt"))
    eng.next_step()
    assert "saveReplay is not set" in capsys.readouterr().out
    assert not (tmp_path / "other.txt").exists()
    assert not (tmp_path / "replay.txt").exists()


def test_replay_lines_carry_the_lane_change_offset(tmp_path):
    """Under lane change (config_lc_single.json) a changing vehicle is
    drawn between its lane and the side lane and carries its last change
    direction."""
    with open(os.path.join(FIX, "config_lc_single.json")) as f:
        cfg = json.load(f)
    cfg.update(dir=FIX + "/", saveReplay=True,
               roadnetLogFile=str(tmp_path / "rlog.json"),
               replayLogFile=str(tmp_path / "replay.txt"))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    eng = Engine(str(path), device="cpu")
    offsets = 0
    for _ in range(175):
        eng.next_step()
        c = eng._fetch()
        offsets += int(((c["offset"] != 0) & c["running"]
                        & ~c["is_shadow"]).sum())
    lines = (tmp_path / "replay.txt").read_text().splitlines()
    assert len(lines) == 175 and offsets > 0
    dirs = {v[3] for line in lines for v in _parse(line)[0].values()}
    assert dirs & {1, -1}
