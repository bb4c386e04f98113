"""O2 phase_pressure: the plain version against a numpy walk of the
reference rule, on the seeded edge cases of
cityflow_tpu_torch/tools/kernel_cases.py (the cases chip_smoke.py holds
the CUDA kernel to on the card, bit for bit), and the lane tables the
kernel reads in place of the index tables.

The walk restates the JAX package's phase_pressures / phase_features /
max_pressure_phases_ring (cityflow_tpu/core/ring_observe.py:35-112) link
by link and phase by phase with Python loops: a link's start waiting is
the count of lane in_src[start_src] (0 where either is -1), its end
waiting that of lane end_src (0 for -1); it is available in phase ph of
intersection g when its roadlink row rl_src = rl * G + col is not -1 and
phase_rl_avail[clip(g_phase_offset[col] + ph, 0, TP - 1), rl] > 0.5;
phase ph is valid when ph < g_n_phases[g]. MaxPressure: the sum of start
- end over the available links, -inf where not valid, the action the
first maximum (0 when every phase is -inf, and for the virtual
intersections g >= G); features: the sums of start and of start - end (0
where not valid) and w_up, the start waiting of every link.
"""

import numpy as np
import pytest
import torch

from cityflow_tpu_torch.kernels import phase_pressure as o2
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_follow_cases import _bits_equal


def _links(tabs):
    """Per (link row l * G + g): (start lane, end lane, roadlink, column)."""
    G = tabs["g_n_phases"].shape[0]
    ins = tabs["in_src"].reshape(-1)
    out = []
    for r, s in enumerate(tabs["start_src"]):
        start = ins[s] if s >= 0 else -1
        rl = tabs["rl_src"][r]
        out.append((start, tabs["end_src"][r], rl // G if rl >= 0 else -1,
                    rl % G if rl >= 0 else -1))
    return out


def _avail(tabs, rl, col, ph):
    if rl < 0:
        return False
    TP = tabs["phase_rl_avail"].shape[0]
    row = min(max(int(tabs["g_phase_offset"][col]) + ph, 0), TP - 1)
    return bool(tabs["phase_rl_avail"][row, rl] > 0.5)


def walk(c):
    """(pressure, actions, fw, fp, w_up) and the edges met."""
    tabs, w, P, I = c["tabs"], c["w"], c["P"], c["I"]
    G = tabs["g_n_phases"].shape[0]
    N, B = w.shape
    LPI = tabs["start_src"].shape[0] // G
    links = _links(tabs)
    wf = w.astype(np.float32)
    cnt = lambda lane: wf[lane] if lane >= 0 else np.zeros(B, np.float32)
    press = np.zeros((G, P, B), np.float32)
    fw = np.zeros((G, P, B), np.float32)
    fp = np.zeros((G, P, B), np.float32)
    w_up = np.zeros((G, B), np.float32)
    actions = np.zeros((I, B), np.int32)
    ev = set()
    TP = tabs["phase_rl_avail"].shape[0]
    for g in range(G):
        nph = int(tabs["g_n_phases"][g])
        for l in range(LPI):
            start, end, rl, col = links[l * G + g]
            w_up[g] += cnt(start)
            ev.add("no_start" if start < 0 else "start")
            ev.add("no_end" if end < 0 else "end")
            ev.add("no_roadlink" if rl < 0 else "roadlink")
            if rl >= 0 and col != g:
                ev.add("other_column")
            for ph in range(P):
                if rl >= 0:
                    raw = int(tabs["g_phase_offset"][col]) + ph
                    ev.add("clipped_high" if raw > TP - 1 else
                           "clipped_low" if raw < 0 else "row")
                if not _avail(tabs, rl, col, ph):
                    continue
                fw[g, ph] += cnt(start)
                fp[g, ph] += cnt(start) - cnt(end)
        for ph in range(P):
            if ph >= nph:
                press[g, ph] = -np.inf
                fw[g, ph] = 0.0
                fp[g, ph] = 0.0
            else:
                press[g, ph] = fp[g, ph]
        if nph == 0:
            ev.add("no_phase")
        for b in range(B):
            best, arg = press[g, 0, b], 0
            for ph in range(1, P):
                if press[g, ph, b] > best:
                    best, arg = press[g, ph, b], ph
                elif press[g, ph, b] == best and best > -np.inf:
                    ev.add("tie_first_wins")
            actions[g, b] = arg
    if I > G:
        ev.add("virtual")
    return (press, actions, fw, fp, w_up), ev


@pytest.mark.parametrize("name", kc.PRESSURE_CASES)
def test_pressure_plain_matches_reference_walk(name):
    case = kc.pressure_case(name)
    (press, actions, fw, fp, w_up), _ = walk(case)
    a = kc.pressure_args(case, "cpu")
    got = o2.phase_pressure(*a)
    assert _bits_equal(got[0].numpy(), press) == 0, name
    assert np.array_equal(got[1].numpy(), actions), name
    got = o2.phase_pressure(*a, features=True)
    for g, w in zip(got, (fw, fp, w_up)):
        assert _bits_equal(g.numpy(), w) == 0, name


def test_pressure_cases_reach_their_edges():
    """P = 1, an odd P, 33 and MAX_P = 64; B = 1, 3, 128 and 130; 40
    links an intersection and more; I > G and I = G; and every edge of
    the rule: links without a start lane, end lane or roadlink, a
    roadlink of another intersection's column, offsets clipped at both
    ends of the table, intersections with no phase, ties."""
    seen = {"P": set(), "B": set(), "LPI": set(), "virt": set()}
    union = set()
    for _, c in kc.pressure_cases():
        G = c["tabs"]["g_n_phases"].shape[0]
        seen["P"].add(c["P"])
        seen["B"].add(c["w"].shape[1])
        seen["LPI"].add(c["tabs"]["start_src"].shape[0] // G)
        seen["virt"].add(c["I"] > G)
        union |= walk(c)[1]
    assert {1, 33, o2.MAX_P} <= seen["P"]
    assert any(p % 2 and p > 1 for p in seen["P"])
    assert {1, 3, 128, 130} <= seen["B"]
    assert max(seen["LPI"]) >= 40 and seen["virt"] == {True, False}
    want = {"no_start", "no_end", "no_roadlink", "other_column",
            "clipped_high", "clipped_low", "no_phase", "tie_first_wins",
            "virtual"}
    assert want <= union, want - union


@pytest.mark.parametrize("name", kc.PRESSURE_CASES)
def test_lane_tables_count_each_link_once(name):
    """The kernel's tables (built here on the CPU tensors): per
    intersection its distinct start and end lanes, and per lane the links
    that start there (cup), those available in phase ph (cs[ph], every ph
    < MAX_P) and cs[ph] less the available links that end there (cp[ph]),
    as the walk's links give them."""
    case = kc.pressure_case(name)
    tabs = kc.pressure_args(case, "cpu")[1]
    lanes, coef = (t.numpy() for t in o2.lane_tables(tabs))
    G = case["tabs"]["g_n_phases"].shape[0]
    assert lanes.shape[0] == G and coef.shape == lanes.shape + (o2.CW,)
    want = {}
    for r, (start, end, rl, col) in enumerate(_links(case["tabs"])):
        g = r % G
        av = np.array([_avail(case["tabs"], rl, col, ph)
                       for ph in range(o2.MAX_P)], np.int64)
        for lane, sign in ((start, 1), (end, -1)):
            if lane < 0:
                continue
            c = want.setdefault((g, int(lane)), np.zeros(o2.CW, np.int64))
            if sign > 0:
                c[0] += 1
                c[o2.CS:o2.CS + o2.MAX_P] += av
            c[o2.CP:o2.CP + o2.MAX_P] += sign * av
    got = {(g, int(lane)): coef[g, e].astype(np.int64)
           for g in range(G) for e, lane in enumerate(lanes[g]) if lane >= 0}
    assert got.keys() == want.keys()
    for k, c in want.items():
        assert np.array_equal(got[k], c), k


def test_pressure_cases_stage_lanes_in_chunks():
    """Some cases give an intersection more lanes than a block stages at
    once: 8 at B = 3 (32 rows of 4 envs), 64 from B = 32 on."""
    E = {}
    for name, c in kc.pressure_cases():
        B = c["w"].shape[1]
        e = o2.lane_tables(kc.pressure_args(c, "cpu")[1])[0].shape[1]
        E[B] = max(E.get(B, 0), e)
    assert E[3] > 8 and max(e for b, e in E.items() if b >= 32) > 64, E


def test_lane_tables_are_built_once_per_tables_dict():
    """Built on first use and kept in the tables' dict; another dict of
    the same net gets tables of its own, equal to the first."""
    case = kc.pressure_case(kc.PRESSURE_CASES[1])
    tabs = kc.pressure_args(case, "cpu")[1]
    assert o2.LANES not in tabs
    first = o2.lane_tables(tabs)
    assert tabs[o2.LANES] is first[0] and tabs[o2.COEF] is first[1]
    again = o2.lane_tables(tabs)
    assert again[0] is first[0] and again[1] is first[1]
    other = o2.lane_tables(kc.pressure_args(case, "cpu")[1])
    assert other[0] is not first[0]
    for a, b in zip(first, other):
        assert torch.equal(a, b)
