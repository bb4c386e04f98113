"""Stage a scenario config under the checkout's build/ directory.

A config's `dir` may be an absolute path of the machine it was written on
(the benchmark configs name one), and the benchmark roadnets are generator
output that git does not carry. `prepare` writes a copy of the config under
`build/scenarios/<config name>/` whose `dir` is that directory and holds
its roadnet and flow: a generated grid roadnet is regenerated there by the
port's gridgen, and every other file is copied from beside the config file,
or from the config's own `dir` when it is not there. Nothing is written
outside `build/`, so two checkouts never share a scenario.

    from cityflow_tpu_torch.tools.scenario import prepare
    cfg_path = prepare("benchmarks/config_30x30.json")

With `templates` (a list of CityFlow `vehicle` objects) the staged flow
file gives flow i the vehicle templates[i % len(templates)]: a mixed-
template variant of the same traffic, e.g. the three vehicles of
tests/fixtures/flow_2x2_mixed.json over benchmarks/flow_30_30.json:

    prepare("benchmarks/config_30x30.json", name="config_30x30_mixed",
            templates=mixed_templates("tests/fixtures/flow_2x2_mixed.json"))
"""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GEN_GRID = {"roadnet_16_16.json": 16, "roadnet_30_30.json": 30}


def resolve_config(path):
    """A relative config path that does not exist from the CWD resolves
    against the checkout's root."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    cand = os.path.join(ROOT, path)
    return cand if os.path.exists(cand) else path


def _find(name, dirs):
    for d in dirs:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"{name} is in none of {list(dirs)}")


def _place(src, dst):
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copy(src, dst)


def mixed_templates(flow_path):
    """The distinct `vehicle` objects of a flow file, in their order of
    first appearance."""
    with open(resolve_config(flow_path)) as f:
        flows = json.load(f)
    out = []
    for fl in flows:
        if fl["vehicle"] not in out:
            out.append(fl["vehicle"])
    return out


def prepare(cfg_path, name=None, templates=None, **overrides):
    """Stage the config's roadnet and flow under build/scenarios/<name>/
    (default: the config's file name) and return the path of the staged
    config; `overrides` replace config keys (routerType="DURATION"), and
    `templates` replaces flow i's vehicle by templates[i % len]."""
    from cityflow_tpu_torch.tools import gridgen
    cfg_path = os.path.abspath(resolve_config(cfg_path))
    with open(cfg_path) as f:
        cfgj = json.load(f)
    here = os.path.dirname(cfg_path)
    base = os.path.join(here, cfgj.get("dir", ""))   # absolute dir wins
    cfgj.update(overrides)
    out = os.path.join(ROOT, "build", "scenarios", name or
                       os.path.splitext(os.path.basename(cfg_path))[0])
    os.makedirs(out, exist_ok=True)
    rn, fl = cfgj["roadnetFile"], cfgj["flowFile"]
    if rn in GEN_GRID:
        n = str(GEN_GRID[rn])
        gridgen.main([n, n, "--dir", out + "/", "--roadnetFile", rn,
                      "--flowFile", "gridgen_flow.json"])
    else:
        _place(_find(rn, (here, base)), os.path.join(out, rn))
    _place(_find(fl, (here, base)), os.path.join(out, fl))
    if templates:
        with open(os.path.join(out, fl)) as f:
            flows = json.load(f)
        for i, flow in enumerate(flows):
            flow["vehicle"] = dict(templates[i % len(templates)])
        with open(os.path.join(out, fl), "w") as f:
            json.dump(flows, f)
    cfgj["dir"] = out + "/"
    path = os.path.join(out, "config.json")
    with open(path, "w") as f:
        json.dump(cfgj, f)
    return path
