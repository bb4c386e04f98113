"""The port's gen-1 Engine on the CPU against the reference goldens
(tests/goldens, dumped from the unmodified C++ engine) at atol=0: every
running vehicle's drivable, distance and speed after every step, as
tests/test_golden_grids.py and test_golden_rl.py hold the JAX package."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from golden_util import (compare_step, golden_records,  # noqa: E402
                         rl_phase_commands)

from cityflow_tpu_torch.engine import Engine  # noqa: E402

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))

CASES = {
    "2x2": ("config_2x2.json", "grid2x2_1000.jsonl.gz", False),
    "4x4": ("config_4x4.json", "grid4x4_1000.jsonl.gz", False),
    "2x2_mixed": ("config_2x2_mixed.json", "grid2x2_mixed_1000.jsonl.gz",
                  False),
    "4x4_rl": ("config_4x4_rl.json", "grid4x4_rl_1000.jsonl.gz", True),
}


def _run_parity(case, n_steps):
    config, golden, rl = CASES[case]
    eng = Engine(os.path.join(HERE, "fixtures", config), device="cpu")
    ids = sorted(i.id for i in eng.net.host.net.intersections
                 if not i.virtual)
    gold = golden_records(golden)
    next(gold)
    errors = []
    for t in range(n_steps):
        if rl:
            for iid, ph in rl_phase_commands(t, ids):
                eng.set_tl_phase(iid, ph)
        eng.next_step()
        g = next(gold)
        assert g["t"] == t + 1
        errors += compare_step(eng, g, t + 1)
        if len(errors) > 20:
            break
    assert not errors, "\n".join(errors[:20])
    assert eng.get_vehicle_count() > 0


@pytest.mark.parametrize("case, n_steps", [
    ("2x2", 300), ("4x4", 100), ("2x2_mixed", 200), ("4x4_rl", 200)])
def test_gen1_engine_matches_golden(case, n_steps):
    _run_parity(case, n_steps)


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CASES))
def test_gen1_engine_matches_golden_1000(case):
    _run_parity(case, 1000)
