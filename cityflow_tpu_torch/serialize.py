"""Archive disk round trip (reference: archive.cpp:153-550 dump / load).

The state's leaves in the JAX package's leaf order (the gen-1 SimState,
or on the ring backend the RingState's allocated leaves and a "ring"
block with the step count and the overflow bits it accepted), plus the
host aux (pushed ids, the spawn / RNG stream state) as JSON, in the JAX
package's "cityflow_tpu/archive/v2" format: dump -> load_from_file
reproduces the trajectory, and an archive of either package loads into
the other's engine of the same backend.
"""

import base64
import json
from dataclasses import replace as dc_replace

import numpy as np

from cityflow_tpu_torch.carry import (
    ring_state_from_numpy, sim_state_from_numpy, sim_state_to_numpy)
from cityflow_tpu_torch.core.state import SIM_FIELDS

FORMATS = ("cityflow_tpu/archive/v1", "cityflow_tpu/archive/v2")


def _enc(a):
    a = np.asarray(a)       # (np.ascontiguousarray makes a 0-dim array 1-dim)
    return {"d": base64.b64encode(np.ascontiguousarray(a).tobytes()).decode(),
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
    if "ring_step" in archive.host_aux:
        leaves = [v.cpu().numpy() for v in archive.state.leaves().values()]
    else:
        st = sim_state_to_numpy(archive.state)
        leaves = [st[k] for k in SIM_FIELDS]
    doc = {
        "format": FORMATS[1],
        "leaves": [_enc(a) for a in leaves],
        "host_aux": {"pushed": {str(k): v for k, v in
                                archive.host_aux["pushed"].items()},
                     "manually_pushed": archive.host_aux["manually_pushed"]},
    }
    if "ring_step" in archive.host_aux:
        doc["ring"] = {"step": int(archive.host_aux["ring_step"]),
                       "ov": int(archive.host_aux.get("ring_ov", 0))}
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
    ring = doc.get("ring")
    if (ring is not None) != (engine._ring is not None):
        mine = "ring" if engine._ring is not None else "gen1"
        raise RuntimeError(
            "archive layout mismatch: dumped from a "
            f"{'ring' if ring is not None else 'gen1'}-backend engine, "
            f"loading into a {mine}-backend engine")
    aux = {"pushed": {int(k): v for k, v in doc["host_aux"]["pushed"].items()},
           "manually_pushed": doc["host_aux"]["manually_pushed"]}
    leaves = [_dec(e) for e in doc["leaves"]]
    if ring is not None:
        # the allocated leaves of the engine's own ring state name them;
        # the rings may have grown (ring_backend.RingShell.load)
        names = list(engine._ring.sim.state.leaves())
        if len(names) != len(leaves):
            raise RuntimeError(f"{path}: {len(leaves)} ring leaves, the "
                               f"engine's ring state has {len(names)}")
        state = ring_state_from_numpy(dict(zip(names, leaves)),
                                      engine.device)
        aux["ring_step"] = ring["step"]
        aux["ring_ov"] = ring["ov"]
    else:
        state = sim_state_from_numpy(dict(zip(SIM_FIELDS, leaves)),
                                     engine.device, engine.cfg.dtype)
        v_loaded = state.active.shape[0]
        if v_loaded != engine.cfg.max_vehicles:
            # the dump may come from an engine whose slot pool had grown
            engine.cfg = dc_replace(engine.cfg, max_vehicles=v_loaded)
    if "spawn" in doc:
        aux["spawn"] = doc["spawn"]
    engine.load(Archive(state, aux))
