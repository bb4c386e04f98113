"""Archive disk round trip (reference: archive.cpp:153-550 dump / load).

The gen-1 SimState's leaves, in the JAX package's leaf order, plus the
host aux (pushed ids, the spawn / RNG stream state) as JSON, in the JAX
package's "cityflow_tpu/archive/v2" format: dump -> load_from_file
reproduces the trajectory.
"""

import base64
import json
from dataclasses import replace as dc_replace

import numpy as np

from cityflow_tpu_torch.carry import sim_state_from_numpy, sim_state_to_numpy
from cityflow_tpu_torch.core.state import SIM_FIELDS

FORMATS = ("cityflow_tpu/archive/v1", "cityflow_tpu/archive/v2")


def _enc(a):
    a = np.ascontiguousarray(a)
    return {"d": base64.b64encode(a.tobytes()).decode(),
            "s": list(a.shape), "t": a.dtype.str}


def _dec(e):
    return np.frombuffer(base64.b64decode(e["d"]),
                         dtype=np.dtype(e["t"])).reshape(e["s"])


def _spawn_jsonable(snap: dict) -> dict:
    out = dict(snap)
    out["origin_fs"] = {k: np.asarray(v).tolist()
                        for k, v in snap["origin_fs"].items()}
    return out


def dump_archive(archive, path: str):
    leaves = sim_state_to_numpy(archive.state)
    doc = {
        "format": FORMATS[1],
        "leaves": [_enc(leaves[k]) for k in SIM_FIELDS],
        "host_aux": {"pushed": {str(k): v for k, v in
                                archive.host_aux["pushed"].items()},
                     "manually_pushed": archive.host_aux["manually_pushed"]},
    }
    if "spawn" in archive.host_aux:
        doc["spawn"] = _spawn_jsonable(archive.host_aux["spawn"])
    with open(path, "w") as f:
        json.dump(doc, f)


def load_archive_into(engine, path: str):
    from cityflow_tpu_torch.engine import Archive
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") not in FORMATS:
        raise RuntimeError(f"{path}: not a cityflow_tpu archive")
    if "ring" in doc:
        raise NotImplementedError(
            "ring-engine archives are not ported yet (see ROADMAP.md)")
    state = sim_state_from_numpy(
        dict(zip(SIM_FIELDS, (_dec(e) for e in doc["leaves"]))),
        engine.device)
    v_loaded = state.active.shape[0]
    if v_loaded != engine.cfg.max_vehicles:
        # the dump may come from an engine whose slot pool had grown
        engine.cfg = dc_replace(engine.cfg, max_vehicles=v_loaded)
    aux = {"pushed": {int(k): v for k, v in doc["host_aux"]["pushed"].items()},
           "manually_pushed": doc["host_aux"]["manually_pushed"]}
    if "spawn" in doc:
        aux["spawn"] = doc["spawn"]
    engine.load(Archive(state, aux))
