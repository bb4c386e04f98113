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


def prepare(cfg_path):
    """Stage the config's roadnet and flow under build/scenarios/ and
    return the path of the staged config."""
    from cityflow_tpu_torch.tools import gridgen
    cfg_path = os.path.abspath(resolve_config(cfg_path))
    with open(cfg_path) as f:
        cfgj = json.load(f)
    here = os.path.dirname(cfg_path)
    base = os.path.join(here, cfgj.get("dir", ""))   # absolute dir wins
    out = os.path.join(ROOT, "build", "scenarios",
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
    cfgj["dir"] = out + "/"
    path = os.path.join(out, "config.json")
    with open(path, "w") as f:
        json.dump(cfgj, f)
    return path
