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
    the run tool and the G5-G8 wrappers."""
    files = {os.path.relpath(p, PKG) for p in _port_sources()}
    for rel in ("core/lanechange.py", "replay.py", "tools/simple_run.py",
                "kernels/hist_window.py", "kernels/lc_probe.py",
                "kernels/lc_plan.py", "kernels/lc_commit.py"):
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
