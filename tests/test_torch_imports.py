"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU on their own, and
the branches it does not cover yet fail at build_sim."""

import ast
import json
import os
import shutil

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


@pytest.mark.parametrize("config, why", [
    ("config_2x2_lc.json", "lane change"),
    ("config_2x2_mixed.json", "non-uniform vehicle templates"),
])
def test_unported_branches_fail_at_build_sim(config, why):
    net = compile_scenario(os.path.join(HERE, "fixtures", config))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ring_sim.build_sim(net, horizon=8, device="cpu")


def test_duration_router_fails_at_build_sim(tmp_path):
    src = os.path.join(HERE, "fixtures")
    with open(os.path.join(src, "config_2x2.json")) as f:
        cfgj = json.load(f)
    for k in ("roadnetFile", "flowFile"):
        shutil.copy(os.path.join(src, cfgj[k]), tmp_path / cfgj[k])
    cfgj.update(dir=str(tmp_path) + "/", routerType="DURATION")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfgj))
    net = compile_scenario(str(path))
    with pytest.raises(NotImplementedError, match="history"):
        ring_sim.build_sim(net, horizon=8, device="cpu")
