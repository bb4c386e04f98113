"""The lane-history window of the DURATION router in the PyTorch port
(core/ring._update_history through O1 lane_stats' history mode) against
the JAX package's, on the CPU.

Both call sites run, per phase from JAX's state: the end of the commit
phase (config_2x2.json with routerType DURATION, 40 steps) and, with lane
change, the one after the shadow inserts in the notify phase
(config_1x1s_lc.json with DURATION, 80 steps, sl=12, sk=6, skc=99). Every
leaf of both phases is compared; the history counts (h_num, h_ring_num,
h_t) must be equal, the speed sums (h_ssum, h_ring_ssum) within 1e-5
relative (the port sums the occupied slots in its own order).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from cityflow_tpu import ring_sim as jax_ring_sim
from cityflow_tpu.compiler.net import compile_scenario as jax_compile
from cityflow_tpu.core import ring as jax_ring

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.carry import mid_from_numpy, ring_state_from_numpy
from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.core import ring
from test_torch_ring import assert_close, jax_leaves, port_leaves

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
REL = 1e-5
SUMS = ("h_ssum", "h_ring_ssum")
CASES = {"2x2": ("config_2x2.json", 40, {}),
         "1x1s_lc": ("config_1x1s_lc.json", 80, dict(sl=12, sk=6, skc=99))}


def duration_config(tmp, name):
    """A copy of fixture `name` with routerType DURATION, roadnet and flow
    beside it in `tmp`."""
    with open(os.path.join(FIX, name)) as f:
        cfgj = json.load(f)
    for k in ("roadnetFile", "flowFile"):
        shutil.copy(os.path.join(FIX, cfgj[k]), os.path.join(tmp, cfgj[k]))
    cfgj.update(dir=str(tmp) + "/", routerType="DURATION")
    path = os.path.join(tmp, "config_duration_" + name)
    with open(path, "w") as f:
        json.dump(cfgj, f)
    return path


def _close(name, want, got):
    if name.split()[-1] in SUMS:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=REL,
                                   atol=0, err_msg=name)
    else:
        assert_close(name, want, got)


@pytest.fixture(scope="module", params=list(CASES))
def duration_run(request, tmp_path_factory):
    """JAX's run of the case phase by phase (numpy leaves: the state each
    step starts from, p1's state and mid, p2's state) and the port's sim."""
    name, steps, kw = CASES[request.param]
    path = duration_config(tmp_path_factory.mktemp(request.param), name)
    jsim = jax_ring_sim.build_sim(jax_compile(path), horizon=steps + 8, **kw)
    tsim = ring_sim.build_sim(compile_scenario(path), horizon=steps + 8,
                              device="cpu", **kw)
    assert jsim.cfg.track_history and tsim.cfg.track_history
    run, st = [], jsim.state
    for _ in range(steps):
        rs1, mid = jax_ring.ring_step_p1(jsim.tables, jsim.cfg, st, jsim.q)
        st2 = jax_ring.ring_step_p2(jsim.tables, jsim.cfg, rs1, mid)
        run.append((jax_leaves(st), jax_leaves(rs1),
                    {k: np.asarray(v) for k, v in mid.items()},
                    jax_leaves(st2)))
        st = st2
    return request.param, tsim, run


def test_history_per_phase_matches_jax(duration_run):
    """Both phases of every step from JAX's state, the history leaves
    included; on the lane-change case the notify phase's update runs (h_t
    advances in p1) and shadows occur."""
    case, tsim, run = duration_run
    lc = tsim.cfg.lane_change
    for t, (st, rs1, mid, st2) in enumerate(run):
        trs1, tmid = ring.ring_step_p1(
            tsim.tables, tsim.cfg, ring_state_from_numpy(st, "cpu"), tsim.q)
        assert int(trs1.h_t) == int(st["h_t"]) + lc
        for k, v in rs1.items():
            _close(f"{case} step {t} p1 {k}", v, getattr(trs1, k).numpy())
        for k, v in mid.items():
            _close(f"{case} step {t} mid {k}", v, tmid[k].numpy())
        tst2 = ring.ring_step_p2(
            tsim.tables, tsim.cfg, ring_state_from_numpy(rs1, "cpu"),
            mid_from_numpy(mid, "cpu"))
        assert set(st2) == set(port_leaves(tst2))
        for k, v in st2.items():
            _close(f"{case} step {t} p2 {k}", v, getattr(tst2, k).numpy())
    last = run[-1][3]
    assert int(last["h_t"]) == len(run) * (1 + lc)
    assert last["h_num"].sum() > 0 and last["h_ssum"].sum() > 0
    if lc:
        assert any(s["l_sh"].any() for s, _, _, _ in run)


def test_history_free_run_and_batched_match_jax(duration_run):
    """The port's own free run: its window sums against JAX's after the
    last step, and batched B=2 equal to the single env bitwise (the
    batched step writes the ring rows in place; the single-env entries
    leave the caller's state as it was)."""
    case, tsim, run = duration_run
    st0 = tsim.state
    before = st0.h_ring_num.clone()
    st = st0
    for _ in range(len(run)):
        st = ring.ring_step(tsim.tables, tsim.cfg, st, tsim.q)
    assert torch.equal(st0.h_ring_num, before)
    want = run[-1][3]
    for k in ("h_num", "h_ring_num", "h_t", "h_ssum", "h_ring_ssum"):
        _close(f"{case} free {k}", want[k], getattr(st, k).numpy())
    bst = ring.batch_ring_state(st0, 2)
    for _ in range(len(run)):
        bst = ring.ring_step_batched(tsim.tables, tsim.cfg, bst, tsim.q)
    got, single = port_leaves(bst), port_leaves(st)
    for k, v in single.items():
        for b in range(2):
            assert np.array_equal(got[k][..., b], v), f"{case} {k} env {b}"
