"""G15 shadow_insert: the plain version against a numpy walk of the
reference's rule, on the seeded edge cases of
cityflow_tpu_torch/tools/kernel_cases.py (the cases chip_smoke.py holds the
CUDA kernel to on the card, bit for bit).

The walk restates LaneChange::insertShadow (lanechange.cpp:71-102) as the
JAX package schedules it (core/lanechange.py:228-291), env by env with
Python lists: the first MS changers in slot order pair with the first MS
free slots in slot order; each pair's shadow is a copy of its real (params
too) on the real's target lane, with priority 2^30 + uid and uid | 2^30
(int32 arithmetic), the list ticket the env's seq_counter before the call,
partner the real, the shadow and running flags set and the per-step
fields cleared; the real's partner becomes the shadow's slot. A changer
with no free slot left sets OV_SLOTS; seq_counter advances by one in every
env.

Also here: G15 writes its state in place (every other row as it was, the
returned tensors the state's own); the step's calls meet the kernel's
preconditions on the lane-change fixture; `step` leaves its input
state as it was on a step that inserts shadows, at B = 1 and B = 3; and
chip_smoke.py records each gen-1 kernel call of such a step with the
arguments as they were at the call.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from cityflow_tpu_torch.core import step as step_mod
from cityflow_tpu_torch.core.state import OV_SLOTS, SIM_FIELDS, SimState
from cityflow_tpu_torch.engine import Engine
from cityflow_tpu_torch.kernels import MODULES, shadow_insert
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_follow_cases import _bits_equal

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SHBIT = 1 << 30


def _wrap32(x):
    return np.int64(x).astype(np.int32)


def walk(c):
    """(leaves, seq_counter, overflow, pairs) after the inserts; pairs as
    {env: [(real, slot), ...]}."""
    lv = {k: v.copy() for k, v in c["leaves"].items()}
    B, V = c["do_change"].shape
    MS = c["MS"]
    seq = c["seq_counter"].copy()
    ov = c["overflow"].copy()
    pairs = {}
    fill = dict(shadow_insert.SET)
    for b in range(B):
        changers = [v for v in range(V) if c["do_change"][b, v]][:MS]
        free = [v for v in range(V) if not c["leaves"]["active"][b, v]][:MS]
        if len(changers) > len(free):
            ov[b] |= OV_SLOTS
        pairs[b] = list(zip(changers, free))
        for real, slot in pairs[b]:
            for k in lv:
                lv[k][b, slot] = c["leaves"][k][b, real]
            for k, x in fill.items():
                lv[k][b, slot] = x
            uid = c["leaves"]["uid"][b, real]
            lv["drv"][b, slot] = c["target"][b, real]
            lv["priority"][b, slot] = _wrap32(SHBIT + int(uid))
            lv["uid"][b, slot] = uid | SHBIT
            lv["list_seq"][b, slot] = c["seq_counter"][b]
            lv["partner"][b, slot] = real
            lv["partner"][b, real] = slot
        seq[b] = c["seq_counter"][b] + 1
    return lv, seq, ov, pairs


def _planned(case):
    """The case's leaves as the planned state st2 holds them (lc_target is
    the target, lc_changing gains the changers)."""
    lv = dict(case["leaves"], lc_target=case["target"],
              lc_changing=case["leaves"]["lc_changing"] | case["do_change"])
    return dict(case, leaves=lv)


@pytest.mark.parametrize("name", kc.SHADOW_CASES)
def test_shadow_plain_matches_reference_walk(name):
    """Every leaf, seq_counter and overflow bit for bit; the call writes
    st2's own tensors (it returns them) and no row outside the pairs."""
    case = kc.shadow_case(name)
    st, st2, do_change, target, MS = kc.shadow_args(case, "cpu")
    before = {k: getattr(st2, k).clone() for k in shadow_insert.LEAVES}
    out = shadow_insert.shadow_insert(st, st2, do_change, target, MS)
    want, seq, ov, pairs = walk(_planned(case))
    for k in shadow_insert.LEAVES:
        assert out[k] is getattr(st2, k), k
        assert _bits_equal(out[k].numpy(), want[k]) == 0, (name, k)
    assert out["seq_counter"] is st2.seq_counter
    assert (out["seq_counter"].numpy() == seq).all(), name
    assert (out["overflow"].numpy() == ov).all(), name
    rows = torch.zeros(do_change.shape, dtype=torch.bool)
    for b, ps in pairs.items():
        for real, slot in ps:
            rows[b, real] = rows[b, slot] = True
    for k in shadow_insert.LEAVES:
        assert _bits_equal(out[k][~rows].numpy(), before[k][~rows].numpy()) \
            == 0, k


def test_shadow_cases_reach_their_edges():
    """The set of cases covers: an env with no changer, more changers than
    MS, fewer free slots than changers (OV_SLOTS), MS = 1, a changer in
    the last slot paired with a free slot at 0, envs that differ, changers
    and free slots in several chunks of the kernel's scan, B = 1, 3, 128
    and 130, both float types, V not a multiple of 16 and misaligned
    views; and every changer is active."""
    seen = dict(B=set(), fp=set(), MS=set(), nochg=0, many=0, ov=0,
                last0=0, chunks=0, v16=set(), offset=0, differ=0)
    for name, c in kc.shadow_cases():
        B, V = c["do_change"].shape
        MS = c["MS"]
        seen["B"].add(B)
        seen["fp"].add(c["leaves"]["dis"].dtype)
        seen["MS"].add(MS)
        seen["v16"].add(V % 16 == 0)
        seen["offset"] += c["offset"]
        assert not (c["do_change"] & ~c["leaves"]["active"]).any(), name
        _, _, ov, pairs = walk(c)
        nchg = c["do_change"].sum(1)
        nfree = (~c["leaves"]["active"]).sum(1)
        seen["nochg"] += int((nchg == 0).sum())
        seen["many"] += int((nchg > MS).sum())
        seen["ov"] += int(((nchg > nfree) & (nfree < MS)).sum())
        seen["last0"] += sum((V - 1, 0) in ps for ps in pairs.values())
        nch, chunk = shadow_insert.chunks(B, V)
        seen["chunks"] += any(
            len({r // chunk for r, _ in ps} | {s // chunk for _, s in ps})
            > 1 for ps in pairs.values()) and nch > 1
        seen["differ"] += B > 1 and len({len(ps) for ps in pairs.values()}) \
            > 1
        assert ((ov & OV_SLOTS) > 0).sum() >= ((nchg > nfree) & (
            nfree < MS)).sum()
    assert seen["B"] == {1, 3, 128, 130}
    assert seen["fp"] == {np.dtype(np.float32), np.dtype(np.float64)}
    assert 1 in seen["MS"] and seen["v16"] == {True, False}
    for k in ("nochg", "many", "ov", "last0", "chunks", "offset", "differ"):
        assert seen[k] > 0, k


def test_shadow_insert_refuses_offsets_past_32_bits():
    """The kernel indexes slots with 32-bit offsets: the wrapper refuses
    B * V of 2^31 or more before either branch (offsets_fit) and takes
    the largest path's pool."""
    with pytest.raises(ValueError, match="32-bit"):
        shadow_insert.offsets_fit(2 ** 16, 2 ** 15)
    shadow_insert.offsets_fit(130, 131072)


@pytest.fixture(scope="module")
def lc_engine(tmp_path_factory):
    """config_2x2_lc.json's exact Engine on the CPU and its states after
    steps 63, 65 and 69, in one pool: steps 64, 66 and 70 insert shadows
    (the first of the run)."""
    with open(os.path.join(FIX, "config_2x2_lc.json")) as f:
        c = json.load(f)
    c["dir"] = FIX + "/"
    path = tmp_path_factory.mktemp("shadow") / "config_2x2_lc.json"
    path.write_text(json.dumps(c))
    eng = Engine(str(path), device="cpu", max_vehicles=512,
                 spawn_horizon=100)
    snaps = {}
    for t in range(1, 70):
        eng.next_step()
        if t in (63, 65, 69):
            snaps[t] = eng.state
    V = max(s.active.shape[0] for s in snaps.values())
    from cityflow_tpu_torch.core.state import pad_state
    return eng, [pad_state(s, V) for s in snaps.values()]


def _stack(states):
    return SimState(**{k: torch.stack([getattr(s, k) for s in states])
                       .contiguous() for k in SIM_FIELDS})


def _record(calls):
    mod = MODULES["shadow_insert"]
    orig = mod.shadow_insert

    def rec(st, st2, do_change, target, MS):
        kept = {k: getattr(st2, k).clone() for k in shadow_insert.LEAVES}
        out = orig(st, st2, do_change, target, MS)
        calls.append((st, st2, do_change, kept, out))
        return out
    return mod, orig, rec


@pytest.mark.parametrize("B", [1, 3])
def test_step_leaves_its_input_state_on_a_shadow_step(lc_engine, B):
    """`step` (B = 1: one env lifted, as the Engine runs it; B = 3: three
    envs from different steps) on a state whose step inserts shadows
    leaves every leaf of its input as it was, though G15 writes the step's
    own state in place; and the shadow insert's calls meet the kernel's
    preconditions: every changer active, every shadow into a slot that was
    free, the returned tensors st2's own."""
    eng, states = lc_engine
    net, cfg, spawn = eng._net_dev, eng.cfg, eng._spawn_dev
    cfg = dataclasses.replace(cfg, max_vehicles=states[0].active.shape[0])
    calls = []
    mod, orig, rec = _record(calls)
    inserted = 0
    mod.shadow_insert = rec
    try:
        for i in range(len(states) if B == 1 else 1):
            st = step_mod.lift(states[i]) if B == 1 else _stack(states)
            snap = {k: v.clone() for k, v in st.leaves().items()}
            new = step_mod.step(net, cfg, st, spawn)
            for k, v in st.leaves().items():
                assert torch.equal(v, snap[k]), f"step wrote its input {k}"
            st2_in = calls[-1][1]
            for k in shadow_insert.LEAVES:
                assert getattr(st2_in, k) is not getattr(st, k), k
            inserted += int((new.is_shadow & ~snap["is_shadow"]).sum())
    finally:
        mod.shadow_insert = orig
    assert calls
    for st, st2, do_change, kept, out in calls:
        assert not (do_change & ~kept["active"]).any()
        made = out["active"] & ~kept["active"]      # the new shadows' slots
        assert out["is_shadow"][made].all()
        env = torch.arange(made.shape[0])[:, None].expand(made.shape)[made]
        real = out["partner"][made].long()
        assert kept["active"][env, real].all() and do_change[env, real].all()
        for k in shadow_insert.LEAVES:
            assert out[k] is getattr(st2, k)
    assert inserted > 0, "no shadow inserted"


def _deep_clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_deep_clone(y) for y in x)
    if isinstance(x, dict):
        return {k: _deep_clone(v) for k, v in x.items()}
    return x


def _same(x, y):
    if isinstance(x, torch.Tensor):
        return x.shape == y.shape and x.dtype == y.dtype and bool(
            ((x == y) | (x.isnan() & y.isnan()) if x.is_floating_point()
             else x == y).all())
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(map(_same, x, y))
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    return x == y


def test_recorded_calls_are_the_steps_calls(lc_engine):
    """chip_smoke.record_gen1_calls on a batched step (B = 3) that inserts
    shadows: each recorded call of every gen-1 kernel, replayed, gives
    what that call gave in the step, though G15 writes in place leaves
    that kernels before it in the step were given."""
    import chip_smoke as cs
    eng, states = lc_engine
    net, cfg, spawn = eng._net_dev, eng.cfg, eng._spawn_dev
    cfg = dataclasses.replace(cfg, max_vehicles=states[0].active.shape[0])
    names = cs.GEN1_KERNELS + cs.GEN1_LC_KERNELS
    orig = {n: getattr(MODULES[n], n) for n in names}
    gave = {n: [] for n in names}

    def keep(n):
        def fn(*a, **k):
            out = orig[n](*a, **k)
            gave[n].append(_deep_clone(out))
            return out
        return fn
    st = _stack(states)
    holder = [st]

    def one():
        holder[0] = step_mod.step(net, cfg, holder[0], spawn)
    try:
        for n in names:
            setattr(MODULES[n], n, keep(n))
        calls = cs.record_gen1_calls(one, names)
    finally:
        for n in names:
            setattr(MODULES[n], n, orig[n])
    assert int((holder[0].is_shadow & ~st.is_shadow).sum()) > 0
    assert calls["shadow_insert"] and calls["lc_probe"]
    for n in names:
        assert len(calls[n]) == len(gave[n]), n
        for (a, k), want in zip(calls[n], gave[n]):
            assert _same(orig[n](*a, **k), want), f"{n}: replay differs"
