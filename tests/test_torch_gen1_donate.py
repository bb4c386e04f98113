"""Who owns the state of the port's batched gen-1 step (core/step.step's
`donate`), on the CPU, where every kernel wrapper takes its plain version.

The batched entries (parallel/batch.make_batched_step, make_rollout,
rl/env.CityFlowVecEnv, rl/dqn, tools/bench.py) donate the state they are
given, as the JAX package's make_rollout does (donate_argnums): G11
spawn_slots writes the spawned rows into the state's own leaves and G5
hist_window each env's ring row and window sums into its own rings. The
Engine keeps its state (donate=False): G11 and G5 make fresh leaves and
rings, and the step writes none of its inputs.

Here: the donated batched step against the copying one, bitwise, over 20
steps of config_4x4.json (fast mode) and config_2x2_lc.json under
DURATION (exact mode, through its first shadow inserts), each at B = 3
from envs at different steps (and history counts); the donated step's
leaves and rings are its input's storage, the copying step's never, and
the copying step leaves its input bit for bit; G11's and G5's in-place
forms against the JAX package's spawn_vehicles and update_history
(jax.vmap, jitted under x64) on the seeded cases of
tools/kernel_cases.py, both forms of each against each other on every
case; the overlap refusals; and chip_smoke.py's recorder on a donated
step, whose every recorded call replays to what the step's call gave.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cityflow_tpu.core import state as jstate
from cityflow_tpu.core import step as js

from cityflow_tpu_torch.carry import sim_state_to_numpy
from cityflow_tpu_torch.core import step as ts
from cityflow_tpu_torch.core.state import SIM_FIELDS, SLOT_FILL
from cityflow_tpu_torch.engine import Engine
from cityflow_tpu_torch.kernels import MODULES, hist_window, spawn_slots
from cityflow_tpu_torch.parallel.batch import make_batched_step
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_gen1_batch import _bitwise
from test_torch_gen1_duration import SUM_RTOL
from test_torch_gen1_lc_batch import _duration_config, _same_pool, _stack

torch.set_num_threads(2)
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
STEPS = 20
RINGS = ("hist_ring_num", "hist_ring_ssum", "hist_num", "hist_ssum")
# per config: (fixture, exact, the engine steps whose states are the envs)
SETUPS = {"4x4-fast": ("config_4x4.json", False, (20, 27, 35)),
          "2x2_lc-duration": ("config_2x2_lc.json", True, (63, 65, 69))}


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """Per setup, one Engine's states after its steps as a batch of three
    distinct envs in one pool (the net, the batch's config, the spawn
    table, the batch)."""
    out = {}
    for name, (config, exact, at) in SETUPS.items():
        path = os.path.join(FIX, config)
        if name == "2x2_lc-duration":
            path = _duration_config(tmp_path_factory.mktemp("donate"))
        eng = Engine(path, exact=exact, backend="gen1", device="cpu",
                     max_vehicles=512, spawn_horizon=max(at) + STEPS + 16)
        snaps = []
        for t in range(1, max(at) + 1):
            eng.next_step()
            if t in at:
                snaps.append(eng.state)
        stb = _stack(_same_pool(snaps))
        cfg = dataclasses.replace(eng.cfg, max_vehicles=stb.active.shape[1])
        out[name] = (eng._net_dev, cfg, eng._spawn_dev, stb)
    return out


def _copy(st):
    return st.map(torch.clone)


def _diff(a, b):
    return [k for k in SIM_FIELDS
            if not _bitwise(getattr(a, k), getattr(b, k))]


def _ptrs(st, keys):
    return {k: getattr(st, k).untyped_storage().data_ptr() for k in keys}


@pytest.mark.parametrize("setup", list(SETUPS))
def test_donated_step_equals_the_copying_step(warm, setup):
    """make_batched_step (the state donated) against step(donate=False),
    every SimState leaf bit for bit after each of 20 steps; the copying
    step leaves its input as it was, bit for bit."""
    net, cfg, spawn, stb = warm[setup]
    step_b = make_batched_step(net, cfg, with_obs=False)
    ref, don = _copy(stb), _copy(stb)
    shadows = 0
    for t in range(STEPS):
        kept = _copy(ref)
        nxt = ts.step(net, cfg, ref, spawn)
        assert not _diff(ref, kept), t
        don = step_b(don, spawn)[0]
        assert not _diff(don, nxt), (t, _diff(don, nxt)[:5])
        shadows += int((nxt.is_shadow & ~ref.is_shadow).sum())
        ref = nxt
    assert len(set(stb.step.tolist())) == 3
    assert int(ref.overflow.max()) == 0 and int(ref.running.sum()) > 0
    if cfg.lane_change:
        assert shadows > 0
        assert cfg.track_history and len(set(stb.hist_t.tolist())) == 3


@pytest.mark.parametrize("setup", list(SETUPS))
def test_donated_step_writes_its_input_and_the_copying_step_does_not(
        warm, setup):
    """G11 in place returns the input's own per-slot leaves, cursor and
    overflow, and a donated step's history rings and the leaves no later
    phase recomputes are its input's storage; the copying step's output
    shares no per-slot leaf or ring storage with its input."""
    net, cfg, spawn, stb = warm[setup]
    slot = tuple(SLOT_FILL)
    keys = slot + (RINGS if cfg.track_history else ())
    x = _copy(stb)
    before = _ptrs(x, slot + ("spawn_cursor", "overflow"))
    s1 = ts.spawn_vehicles(net, cfg, x, spawn, donate=True)
    assert _ptrs(s1, before) == before
    x = _copy(stb)
    inp = _ptrs(x, keys)
    out = _ptrs(ts.step(net, cfg, x, spawn, donate=True), keys)
    shared = {k for k in keys if out[k] == inp[k]}
    assert {"params", "route", "priority", "enter_time"} <= shared
    if cfg.track_history:
        assert set(RINGS) <= shared
    x = _copy(stb)
    inp = set(_ptrs(x, keys).values())
    s1 = ts.spawn_vehicles(net, cfg, x, spawn)
    assert not set(_ptrs(s1, slot).values()) & inp
    assert not set(_ptrs(ts.step(net, cfg, x, spawn), keys).values()) & inp


# ---------------------------------------------------------------------------
# G11 and G5, in place, against the JAX package
# ---------------------------------------------------------------------------

def _jstate(st):
    """The port's SimState as the JAX package's."""
    return jstate.SimState(**{k: jnp.asarray(v) for k, v in
                              sim_state_to_numpy(st).items()})


def _jax_spawn(case, st):
    """jax.vmap of spawn_vehicles over the case's envs."""
    B, V = case["leaves"]["active"].shape
    jcfg = jstate.StepConfig(
        interval=float(case["interval"]), num_lanes=1, num_drivables=1,
        max_vehicles=V, max_spawn_per_step=case["MS"],
        exact=case["leaves"]["dis"].dtype == np.float64)
    jnet = {"flow_params": jnp.asarray(case["flow_params"])}
    jtbl = {k: jnp.asarray(v) for k, v in case["tbl"].items()}
    out = jax.jit(jax.vmap(lambda s: js.spawn_vehicles(
        jnet, jcfg, s, jtbl)))(_jstate(st))
    return {k: np.asarray(getattr(out, k)) for k in SIM_FIELDS}


@pytest.mark.parametrize("name", kc.SPAWN_CASES)
def test_spawn_in_place_matches_jax(name):
    """G11 in place (the wrapper on the CPU: the plain version) against
    jax.vmap(spawn_vehicles): every per-slot leaf, spawn_cursor and
    overflow bit for bit (full pools, fewer free slots than due rows,
    windows clamped at the table's end, nothing due, envs at different
    cursors and steps); the returned tensors are the state's own."""
    case = kc.spawn_case(name)
    st, tbl, fp, interval, MS = kc.spawn_args(case, "cpu")
    want = _jax_spawn(case, st)
    ptrs = _ptrs(st, tuple(SLOT_FILL))
    out = spawn_slots.spawn_slots(st, tbl, fp, interval, MS, inplace=True)
    got = sim_state_to_numpy(st.replace_fields(**out))
    assert _ptrs(st.replace_fields(**out), ptrs) == ptrs
    for k in tuple(SLOT_FILL) + ("spawn_cursor", "overflow"):
        g, w = got[k], want[k]
        if g.dtype.kind == "f":
            g, w = g.view(np.int64 if g.itemsize == 8 else np.int32), \
                w.view(np.int64 if w.itemsize == 8 else np.int32)
        np.testing.assert_array_equal(g, w, err_msg=f"{name} {k}")


def test_spawn_cases_reach_their_edges():
    """Between them the JAX-compared G11 cases fill slots, overflow, clamp
    a window at the table's end, spawn nothing in an env and walk past a
    scan tile of free flags."""
    seen = set()
    for name in kc.SPAWN_CASES:
        case = kc.spawn_case(name)
        st, tbl, fp, interval, MS = kc.spawn_args(case, "cpu")
        act0, cur0 = st.active.clone(), st.spawn_cursor.clone()
        out = spawn_slots.spawn_slots(st, tbl, fp, interval, MS,
                                      inplace=True)
        n = tbl["step"].shape[0]
        new = (out["active"] & ~act0).sum(-1)
        due = out["spawn_cursor"] - cur0
        seen |= {"filled"} if int(new.sum()) else set()
        seen |= {"overflow"} if bool((due > new).any()) else set()
        seen |= {"end"} if bool((cur0 > n - MS).any()) else set()
        seen |= {"none"} if bool((due == 0).any()) else set()
        first_free = (~act0).to(torch.int64).argmax(-1)
        seen |= {"late"} if int(first_free.max()) >= 4096 else set()
    assert seen == {"filled", "overflow", "end", "none", "late"}


def _jax_history(case):
    """jax.vmap of update_history over the case's envs (a state holding
    what it reads)."""
    B, V = case["speed"].shape
    HL1, L = case["ring_num"].shape[1:]
    f = case["speed"].dtype
    jcfg = jstate.StepConfig(interval=1.0, num_lanes=L,
                             num_drivables=case["last_of"].shape[1],
                             max_vehicles=V, history_len=HL1 - 1,
                             exact=f == np.float64)
    lv = {k: np.zeros((B, V), bool if k in ("active", "running") else f)
          for k in ("active", "running", "dis")}
    lv.update(running=case["running"], drv=case["drv"], speed=case["speed"])
    st = kc._sim_state(lv, B, f, torch.as_tensor, **{
        k: case[k.replace("hist_ring_", "ring_")] for k in RINGS},
        hist_t=case["hist_t"])
    out = jax.jit(jax.vmap(lambda s: js.update_history(jcfg, s)))(
        _jstate(st))
    return {k: np.asarray(getattr(out, k)) for k in RINGS + ("hist_t",)}


@pytest.mark.parametrize("name", [n for n in kc.HIST_CASES
                                  if n.endswith("f64")
                                  or n.endswith("empty")])
def test_hist_window_in_place_matches_jax(name):
    """G5 in place (plain version) against jax.vmap(update_history): ring
    rows and counts exact, speed sums within SUM_RTOL (JAX's scatter-add
    orders the adds its own way), each env at its own hist_t (below, at
    and past the ring's length), empty lanes and envs; the returned
    tensors are the inputs themselves."""
    case = kc.hist_case(name)
    want = _jax_history(case)
    a = kc.hist_args(case, "cpu")
    got = hist_window.hist_window(*a, inplace=True)
    assert all(g is x for g, x in zip(got, a[5:7] + a[3:5]))
    got = dict(zip(("hist_num", "hist_ssum", "hist_ring_num",
                    "hist_ring_ssum"), (t.numpy() for t in got)))
    for k in ("hist_num", "hist_ring_num"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("hist_ssum", "hist_ring_ssum"):
        np.testing.assert_allclose(got[k], want[k], rtol=SUM_RTOL, atol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(want["hist_t"], case["hist_t"] + 1)


def _equal(got, want):
    return all(_bitwise(g, w) for g, w in zip(
        [got[k] for k in sorted(got)] if isinstance(got, dict) else got,
        [want[k] for k in sorted(want)] if isinstance(want, dict)
        else want))


@pytest.mark.parametrize("name", kc.SPAWN_COPY_CASES)
def test_spawn_forms_agree(name):
    """G11's copying and in-place forms give the same leaves, bit for bit;
    the copying form leaves its input as it was."""
    case = kc.spawn_case(name)
    a = kc.spawn_args(case, "cpu")
    kept = _copy(a[0])
    copied = spawn_slots.spawn_slots(*a)
    assert not _diff(a[0], kept)
    assert _equal(copied, spawn_slots.spawn_slots(
        *kc.spawn_args(case, "cpu"), inplace=True))


@pytest.mark.parametrize("name", kc.HIST_CASES)
def test_hist_window_forms_agree(name):
    """G5's copying and in-place forms give the same rings and sums, bit
    for bit; the copying form leaves its inputs as they were."""
    case = kc.hist_case(name)
    a = kc.hist_args(case, "cpu")
    kept = [t.clone() for t in a]
    copied = hist_window.hist_window(*a)
    assert all(_bitwise(x, y) for x, y in zip(a, kept))
    assert _equal(copied, hist_window.hist_window(
        *kc.hist_args(case, "cpu"), inplace=True))


def test_in_place_forms_refuse_overlapping_outputs():
    """In place, G11 refuses per-slot leaves that overlap in memory and G5
    rings or sums that overlap each other or its inputs (a write would
    reach the other); G11's copying form refuses leaves that do not start
    on the word it copies a slot row in (a view one element in), which
    the in-place form takes."""
    case = kc.spawn_case(kc.SPAWN_CASES[0])
    st, tbl, fp, interval, MS = kc.spawn_args(case, "cpu")
    st = st.replace_fields(prev_drv=st.drv)
    with pytest.raises(ValueError, match="overlap"):
        spawn_slots.spawn_slots(st, tbl, fp, interval, MS, inplace=True)
    spawn_slots.spawn_slots(st, tbl, fp, interval, MS)   # copying: fine
    # the copying form copies rows in words: a view one element in refuses
    off, = set(kc.SPAWN_CASES) - set(kc.SPAWN_COPY_CASES)
    a = kc.spawn_args(kc.spawn_case(off), "cpu")
    with pytest.raises(ValueError, match="aligned"):
        spawn_slots.spawn_slots(*a)
    spawn_slots.spawn_slots(*a, inplace=True)
    a = list(kc.hist_args(kc.hist_case(kc.HIST_CASES[0]), "cpu"))
    a[4] = a[3]
    with pytest.raises(ValueError, match="overlap"):
        hist_window.hist_window(*a, inplace=True)
    hist_window.hist_window(*a)


def test_recorded_calls_of_a_donated_step(warm):
    """chip_smoke.record_gen1_calls on a donated batched step with lane
    change and DURATION (B = 3, shadows inserted): every recorded call of
    every gen-1 kernel, replayed on fresh copies of what it writes, gives
    what that call gave in the step, though G11, G5 and G15 write in
    place what they and the kernels before them were given."""
    import chip_smoke as cs
    net, cfg, spawn, stb = warm["2x2_lc-duration"]
    names = cs.GEN1_KERNELS + cs.GEN1_LC_KERNELS
    orig = {n: getattr(MODULES[n], n) for n in names}
    gave = {n: [] for n in names}

    def keep(n):
        def fn(*a, **k):
            out = orig[n](*a, **k)
            gave[n].append([t.clone() if torch.is_tensor(t) else t
                            for t in cs._flat(out)])
            return out
        return fn
    st = _copy(stb)
    holder = [st]

    def one():
        holder[0] = ts.step(net, cfg, holder[0], spawn, donate=True)
    try:
        for n in names:
            setattr(MODULES[n], n, keep(n))
        calls = cs.record_gen1_calls(one, names)
    finally:
        for n in names:
            setattr(MODULES[n], n, orig[n])
    assert int((holder[0].is_shadow & ~stb.is_shadow).sum()) > 0
    for n in ("spawn_slots", "hist_window"):
        assert calls[n] and all(k.get("inplace") for _, k in calls[n])
    for n in names:
        assert len(calls[n]) == len(gave[n]), n
        for (a, k), want in zip(calls[n], gave[n]):
            got = cs._flat(cs._gen1_call(n, orig[n], a, k))
            assert len(got) == len(want), n
            assert all(_bitwise(g, w) if torch.is_tensor(g) else g == w
                       for g, w in zip(got, want)), f"{n}: replay differs"
