"""Free-running PyTorch ring trajectories on config_4x4.json, on the CPU:
against the JAX package's ring_step (the tests/test_ring.py:_run_compare
contract: same vehicles on the same drivables, |dis|, |speed| within 2e-3,
same finished count) and, inside the port, batched against single-env
(bitwise)."""

import os

import numpy as np
import pytest
import torch

from cityflow_tpu.core import ring as jax_ring

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.core import ring
from test_torch_ring import (CONFIG, build_pair, jax_leaves, port_leaves,
                             vehicles)

torch.set_num_threads(2)


@pytest.mark.parametrize("config, steps", [
    (CONFIG, 100),
    # the 2x2 grid reaches removals (finished vehicles) inside the window
    (os.path.join(os.path.dirname(CONFIG), "config_2x2.json"), 250),
    # rlTrafficLight: the lights hold their phase (no passTime)
    (os.path.join(os.path.dirname(CONFIG), "config_4x4_rl.json"), 60),
], ids=["4x4", "2x2", "4x4_rl"])
def test_trajectory_matches_jax(config, steps):
    jsim, tsim = build_pair(config, steps)
    jst, tst = jsim.state, tsim.state
    worst = 0.0
    for i in range(1, steps + 1):
        jst = jax_ring.ring_step(jsim.tables, jsim.cfg, jst, jsim.q)
        tst = ring.ring_step(tsim.tables, tsim.cfg, tst, tsim.q)
        if i % 10:
            continue
        a = vehicles(jax_leaves(jst))
        b = vehicles(port_leaves(tst))
        assert set(a) == set(b), f"step {i}: vehicle sets differ"
        for u in a:
            assert a[u][0] == b[u][0], f"step {i}: uid {u} {a[u]} vs {b[u]}"
            worst = max(worst, abs(a[u][1] - b[u][1]),
                        abs(a[u][2] - b[u][2]))
        assert worst <= 2e-3, f"step {i}: worst drift {worst}"
    assert len(a) > 50
    assert int(tst.overflow) == 0 == int(np.asarray(jst.overflow))
    assert int(tst.finished_cnt) == int(np.asarray(jst.finished_cnt))
    assert abs(float(tst.cum_travel) - float(np.asarray(jst.cum_travel))) \
        <= 0.02 * max(float(np.asarray(jst.cum_travel)), 1.0)


def test_batched_equals_single_env_bitwise():
    """Batched B=4 against one env; the single-env run alternates
    ring_step and ring_step_split, so the split entry is held to the same
    bits."""
    steps, B = 40, 4
    tsim = ring_sim.build_sim(compile_scenario(CONFIG), horizon=steps + 8,
                              device="cpu")
    st = tsim.state
    for i in range(steps):
        step = ring.ring_step_split if i % 2 else ring.ring_step
        st = step(tsim.tables, tsim.cfg, st, tsim.q)
    bst = ring.batch_ring_state(tsim.state, B)
    for i in range(steps):
        if i % 2:
            bst = ring.ring_step_batched(tsim.tables, tsim.cfg, bst, tsim.q)
        else:
            bst, mid = ring.ring_step_p1_batched(tsim.tables, tsim.cfg, bst,
                                                 tsim.q)
            bst = ring.ring_step_p2_batched(tsim.tables, tsim.cfg, bst, mid)
    want = port_leaves(st)
    got = port_leaves(bst)
    for k, v in want.items():
        for b in range(B):
            assert np.array_equal(got[k][..., b], v), f"{k} env {b}"
    assert int(st.n_l.sum() + st.n_k.sum()) > 50
