"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU on their own, and
the branches it does not cover yet are refused."""

import ast
import json
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


@pytest.mark.parametrize("case, why", [
    ("lane_change", "laneChange"),
    ("duration", "DURATION"),
])
def test_unported_gen1_branches_are_refused(case, why, tmp_path):
    """The gen-1 Engine refuses what it does not step yet, naming
    ROADMAP.md: lane change (config_lc_single.json) and the DURATION
    router (config_2x2.json with routerType DURATION)."""
    from cityflow_tpu_torch.engine import Engine
    fix = os.path.join(HERE, "fixtures")
    if case == "lane_change":
        path = os.path.join(fix, "config_lc_single.json")
    else:
        with open(os.path.join(fix, "config_2x2.json")) as f:
            cfgj = json.load(f)
        cfgj.update(dir=fix + "/", routerType="DURATION")
        path = tmp_path / "config.json"
        path.write_text(json.dumps(cfgj))
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        Engine(str(path), device="cpu")
    assert why in str(e.value)


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
