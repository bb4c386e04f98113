"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU on their
own."""

import ast
import os

import pytest
import torch

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.compiler.net import compile_scenario

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PKG = os.path.join(ROOT, "cityflow_tpu_torch")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(mod):
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "cityflow_tpu")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0 and _forbidden(node.module):
                bad.append((path, node.module))
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str) and \
                    _forbidden(node.args[0].value):
                bad.append((path, node.args[0].value))
    assert not bad, f"forbidden imports: {bad}"


def test_build_sim_without_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the card")
    net = compile_scenario(os.path.join(HERE, "fixtures", "config_2x2.json"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ring_sim.build_sim(net, horizon=8)
    sim = ring_sim.build_sim(net, horizon=8, device="cpu")
    assert sim.state.l_dis.device.type == "cpu"


def test_lane_change_modules_are_covered():
    """The import rule above reaches the lane-change module and kernels,
    and the template kernel T1."""
    files = {os.path.relpath(p, PKG) for p in _port_sources()}
    for rel in ("core/ring_lc.py", "kernels/_nbr.py", "kernels/lc_signal.py",
                "kernels/lc_receive.py", "kernels/lc_insert.py",
                "kernels/lc_partner.py", "kernels/tpl_params.py"):
        assert rel in files, rel


def test_rl_and_observation_modules_are_covered():
    """The import rule above reaches the RL modules and the O kernels."""
    files = {os.path.relpath(p, PKG) for p in _port_sources()}
    for rel in ("core/ring_observe.py", "kernels/lane_stats.py",
                "kernels/phase_pressure.py", "rl/env.py", "rl/dqn.py",
                "rl/ring_dqn.py"):
        assert rel in files, rel


def test_gen1_modules_are_covered():
    """The import rule above reaches the gen-1 engine, step and G kernels."""
    files = {os.path.relpath(p, PKG) for p in _port_sources()}
    for rel in ("engine.py", "serialize.py", "core/state.py", "core/step.py",
                "kernels/arrange.py", "kernels/leader_scan.py",
                "kernels/notify_cross.py", "kernels/cross_pass.py"):
        assert rel in files, rel


def test_gen1_lane_change_history_and_replay_modules_are_covered():
    """The import rule above reaches gen-1 lane change, the replay writer,
    the run tool and the G5-G8 and G15 wrappers."""
    files = {os.path.relpath(p, PKG) for p in _port_sources()}
    for rel in ("core/lanechange.py", "replay.py", "tools/simple_run.py",
                "kernels/hist_window.py", "kernels/lc_probe.py",
                "kernels/lc_plan.py", "kernels/lc_commit.py",
                "kernels/shadow_insert.py"):
        assert rel in files, rel


def test_simple_run_runs_on_the_cpu_and_refuses_fast_mode(capsys):
    """tools/simple_run.py --cpu: the reference CLI's report, from the
    exact (float64) gen-1 Engine. (Named for when --fast was refused; it
    now checks that --fast is Engine(config, exact=False), below.)"""
    from cityflow_tpu_torch.tools import simple_run
    eng = simple_run.main(["--configFile", os.path.join(
        HERE, "fixtures", "config_2x2.json"), "-s", "30", "--cpu"])
    out = capsys.readouterr().out
    assert "Total Step: 30" in out and "steps/s" in out
    assert eng.device.type == "cpu" and eng.get_current_time() == 30.0
    assert eng._ring is None and eng.state.dis.dtype == torch.float64


def test_simple_run_fast_is_the_inexact_engine(capsys):
    """simple_run --fast --cpu on config_2x2.json: Engine(config,
    exact=False), the ring on a grid, the same report."""
    from cityflow_tpu_torch.tools import simple_run
    eng = simple_run.main(["--configFile", os.path.join(
        HERE, "fixtures", "config_2x2.json"), "-s", "30", "--fast", "--cpu"])
    out = capsys.readouterr().out
    assert "Total Step: 30" in out and "steps/s" in out
    assert eng._ring is not None and eng.get_current_time() == 30.0
    assert eng.get_vehicle_count() > 0


def test_fast_mode_and_ring_engine_modules_are_covered():
    """The import rule above reaches the ring Engine's shell and the G9 /
    G10 wrappers."""
    files = {os.path.relpath(p, PKG) for p in _port_sources()}
    for rel in ("ring_backend.py", "ring_sim.py",
                "kernels/blocker_cycles.py", "kernels/update_location.py"):
        assert rel in files, rel


def test_fast_engines_without_device_refuse_the_cpu():
    """Both backends of Engine(exact=False): device=None is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the card")
    from cityflow_tpu_torch.engine import Engine
    path = os.path.join(HERE, "fixtures", "config_2x2.json")
    for backend in ("auto", "gen1"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Engine(path, exact=False, backend=backend)


def test_gen1_engine_without_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the card")
    from cityflow_tpu_torch.engine import Engine
    path = os.path.join(HERE, "fixtures", "config_2x2.json")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(path)
    assert Engine(path, device="cpu").state.dis.device.type == "cpu"


def test_ring_vec_env_without_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the card")
    from cityflow_tpu_torch.rl.env import RingVecEnv
    path = os.path.join(HERE, "fixtures", "config_2x2.json")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RingVecEnv(path, batch=2, horizon=8)
    env = RingVecEnv(path, batch=2, horizon=8, device="cpu")
    env.reset()
    assert env.state.n_l.device.type == "cpu"


def test_gen1_batch_and_rl_modules_are_covered():
    """The import rule above reaches the batched gen-1 step, its RL surface
    and the G11-G14 wrappers."""
    files = {os.path.relpath(p, PKG) for p in _port_sources()}
    for rel in ("parallel/batch.py", "core/observe.py", "rl/policies.py",
                "rl/env.py", "rl/dqn.py", "kernels/spawn_slots.py",
                "kernels/admit_heads.py", "kernels/lane_counts.py",
                "kernels/phase_scores.py"):
        assert rel in files, rel


def test_city_flow_vec_env_and_dqn_train_without_device_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the card")
    from cityflow_tpu_torch.rl import dqn
    from cityflow_tpu_torch.rl.env import CityFlowVecEnv
    path = os.path.join(HERE, "fixtures", "config_2x2.json")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CityFlowVecEnv(path, batch=2, horizon=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dqn.train(path, batch=2, iters=1)
    env = CityFlowVecEnv(path, batch=2, max_vehicles=64, horizon=8,
                         device="cpu")
    obs = env.reset()
    assert env.state.dis.device.type == "cpu"
    assert obs["lane_count"].shape == (2, env.cfg.num_lanes)


def test_bench_gen1_layout_runs_on_the_cpu(capsys):
    """tools/bench.py --layout gen1 at a tiny size prints the JAX bench's
    keys, with the batched gen-1 step's numbers."""
    import json
    from cityflow_tpu_torch.tools import bench
    bench.main(["--layout", "gen1", "--config",
                os.path.join(HERE, "fixtures", "config_2x2.json"),
                "--batch", "2", "--window", "0", "--steps", "3",
                "--warmup", "4", "--max-vehicles", "256", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("metric", "value", "unit", "vs_baseline", "layout", "batch",
              "steps", "ms_per_batched_step", "compile_s", "device",
              "overflow_flags", "vehicles_per_env", "seconds", "window"):
        assert k in line, k
    assert line["layout"] == "gen1" and line["batch"] == 2
    assert line["steps"] == 3 and line["overflow_flags"] == 0
    assert line["vehicles_per_env"] > 0 and line["value"] > 0


def test_ring_region_modules_are_covered():
    """The import rule above reaches the R1-R7 wrappers."""
    files = {os.path.relpath(p, PKG) for p in _port_sources()}
    for rel in ("kernels/notify_winners.py", "kernels/ring_exits.py",
                "kernels/ring_admit.py", "kernels/route_rows.py",
                "kernels/front_leaders.py", "kernels/gap_refresh.py",
                "kernels/ring_pack.py", "kernels/_ring_idx.py"):
        assert rel in files, rel


@pytest.mark.parametrize("config,kw,lc", [
    ("config_4x4.json", {}, False),
    ("config_1x1s_lc.json", dict(sl=12, sk=6, skc=99), True),
    ("config_2x2_mixed.json", dict(skc=99), False),
    ("config_1x1s_mixed_lc.json", dict(sl=12, sk=6, skc=99), True)])
def test_each_ring_region_runs_through_its_wrapper_once_a_step(config, kw,
                                                               lc):
    """One batched ring step per mode (uniform, lane change, templates,
    both) calls each R wrapper once (R2's pair stages, R5's lane-change
    mode and R6 with lane change only), R7 once in each of its four
    modes, K3 once in its ring-leader mode on the lane rows and once on
    the link rows (twice outside it, on the approach rows), K1 three
    times (the avail rows, the end-lane and start-lane bundles) and K2
    twice (link and approach rows), each time reading R1's fields in
    place through foe_src, and core/ring.py and core/ring_lc.py keep no
    inline copy of those regions."""
    import inspect
    from cityflow_tpu_torch.core import ring, ring_lc
    tsim = ring_sim.build_sim(compile_scenario(os.path.join(
        HERE, "fixtures", config)), horizon=16, device="cpu", **kw)
    names = ("notify_winners", "ring_admit", "ring_exits",
             "ring_exits_pairs", "ring_exits_finish", "route_rows",
             "front_leaders", "front_leaders_lc", "pack_forward",
             "pack_entrants", "pack_candidates", "pack_approach",
             "car_follow", "gather_rows", "cross_caps")
    calls = dict.fromkeys(names + ("gap_refresh", "car_follow@ring-lane",
                                   "car_follow@ring-link",
                                   "cross_caps@foe-in-place"), 0)
    mods = [(ring, n) for n in names] + [(ring_lc, n) for n in (
        "gap_refresh", "gather_rows", "cross_caps") if hasattr(ring_lc, n)]
    orig = {(m, n): getattr(m, n) for m, n in mods}
    B = 2
    NF = 9 * tsim.cfg.KC * tsim.cfg.LKp

    def counted(m, n):
        def fn(*a, **k):
            r = k.get("ring")
            calls[n if r is None else f"{n}@ring-{r.kind}"] += 1
            if n == "cross_caps" and tuple(a[6].shape) == (9, NF // 9, B) \
                    and a[7] is tsim.tables["foe_src"]:
                calls["cross_caps@foe-in-place"] += 1
            return orig[(m, n)](*a, **k)
        return fn
    try:
        for m, n in mods:
            setattr(m, n, counted(m, n))
        st = ring.batch_ring_state(tsim.state, B)
        ring.ring_step_batched(tsim.tables, tsim.cfg, st, tsim.q)
    finally:
        for (m, n), f in orig.items():
            setattr(m, n, f)
    lc_only = ("ring_exits_pairs", "ring_exits_finish", "front_leaders_lc",
               "gap_refresh")
    per_step = dict(car_follow=2, gather_rows=3, cross_caps=2)
    per_step["cross_caps@foe-in-place"] = 2
    assert calls == {n: (per_step[n] if n in per_step else
                         1 if lc or n not in lc_only else 0)
                     for n in calls}
    src = inspect.getsource(ring)
    for inline in ("torch.sort(", "putc(", "can_yield(", "reach_steps(",
                   "blk_new", "range(cfg.k_phase)", "range(cfg.k_cyc)",
                   "cross_l", "leave_pref", "rn_at(", "_kout_min",
                   "shift_in(", "torch.stack(fch)", "payload = torch.stack(",
                   "to_link_idx(", "lk_ch = torch.stack",
                   "gather_rows(fields"):
        assert inline not in src, inline
    src_lc = inspect.getsource(ring_lc)
    for inline in ("_kout_min", "shift_in(", "leader_scan_bound("):
        assert inline not in src_lc, inline
