"""G3 notify_cross: the plain version against a numpy walk of the
reference's rule, on the seeded edge cases of
cityflow_tpu_torch/tools/kernel_cases.py (the cases chip_smoke.py holds
the CUDA kernel to on the card, bit for bit).

The walk restates Engine::threadNotifyCross (engine.cpp:317-372) cross
by cross, with Python loops: the candidates in order, the end lane's rear
vehicle while it is still on the lanelink (its tail before the cross,
strictly), the lanelink's first k_link vehicles in G1's order
(sorted_idx from drv_off) front to back (their tail at or before the
cross), the start lane's front vehicle when it is about to enter (its
next drivable is the lanelink, which is available); the notifier is the
first with the largest front position. Its Cross::canPass terms
(roadnet.cpp:604-660) follow from the state's leaves: whether it exists,
can yield, has cleared the cross, is in a blocker cycle, has passed it,
its distance, reach steps, enter time, priority and slot; without a
notifier the terms come from the end lane's rear vehicle (slot 0 where
there is none: the plain version's default index 0).
"""

import numpy as np
import pytest
import torch

from cityflow_tpu_torch.kernels import arrange, notify_cross
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_cross_cases import _can_yield, _reach
from test_torch_follow_cases import (  # noqa: F401 (ieee_sqrt: a fixture)
    _bits_equal, ieee_sqrt)

P_LEN, P_MAXNEGACC, P_USUALPOSACC, P_MAXSPEED, P_YIELD, P_TURNSPEED = \
    1, 4, 5, 8, 10, 11
OUT = ("exists", "yield", "cleared", "cyc", "dpos", "dist", "reach", "ent",
       "pri", "idx")


def walk(c, envs=None):
    """The ten own-side tables, (B, LL, KC) each, and the edges met."""
    net, arr, lv = c["net"], c["arr"], c["leaves"]
    cd = net["lnk_cross_d"]
    LL, KC = cd.shape
    F = cd.dtype.type
    L, K = c["L"], c["k_link"]
    B, V = lv["dis"].shape
    envs = range(B) if envs is None else envs
    out = {k: np.zeros((len(envs), LL, KC), bool) for k in OUT[:5]}
    out["dist"] = np.zeros((len(envs), LL, KC), F)
    for k in OUT[6:]:
        out[k] = np.zeros((len(envs), LL, KC), np.int32)
    ev = set()
    dt = net["interval"][()]
    for i, b in enumerate(envs):
        dis, p = lv["dis"][b], lv["params"][b]
        for l in range(LL):
            ll_len = net["drv_len"][L + l]
            last = arr["last_of"][b, net["ll_end"][l]]
            ls = min(max(last, 0), V - 1)
            first = arr["first_of"][b, net["ll_start"][l]]
            fs = min(max(first, 0), V - 1)
            e_ok = last >= 0 and lv["prev_drv"][b, ls] == L + l
            s_next = c["veh_next"][b, fs]
            s_ok = first >= 0 and s_next == L + l \
                and c["ll_avail"][b, l]
            if last >= 0 and not e_ok:
                ev.add("e_ok_fails_by_prev")
            if first >= 0 and not s_ok:
                ev.add("s_ok_fails_by_next" if s_next != L + l
                       else "s_ok_fails_by_avail")
            # (eligible at cross distance d, front position, slot whose
            # leaves hold the terms, notifier slot)
            cands = [(lambda d, t=(ll_len + dis[ls]) - p[ls, P_LEN]:
                      e_ok and t < d, ll_len + dis[ls], ls, last)]
            lo = arr["drv_off"][b, L + l]
            n = arr["drv_off"][b, L + l + 1] - lo
            if n > K:
                ev.add("link_over_k")
            for j in range(min(n, K)):
                s = arr["sorted_idx"][b, lo + j]
                cands.append((lambda d, t=dis[s] - p[s, P_LEN]: t <= d,
                              dis[s], s, s))
                if np.isnan(dis[s]):
                    ev.add("nan_dis")
                if dis[s] == 0 and np.signbit(dis[s]):
                    ev.add("neg0_dis")
            cands.append((lambda d: s_ok,
                          -(net["drv_len"][net["ll_start"][l]] - dis[fs]),
                          fs, first))
            for k in range(KC):
                d = cd[l, k]
                best_p, best = F(-1e30), 0
                winner = False
                for m, (elig, pk, *_rest) in enumerate(cands):
                    if elig(d) and pk > best_p:
                        best_p, best, winner = pk, m, True
                    elif elig(d) and pk == best_p and winner:
                        ev.add("tie_first_keeps")
                up, down = np.nextafter(d, np.inf), np.nextafter(d, -np.inf)
                if cands[0][0](up) and not cands[0][0](d):
                    ev.add("end_tail_at_d")          # tail < d: not at d
                if any(e(d) and not e(down) for e, *_ in cands[1:-1]):
                    ev.add("link_tail_at_d")         # tail <= d: at d
                _, _, s, bv = cands[best]
                ndist = d - best_p
                target = p[s, P_TURNSPEED] if net["ll_is_turn"][l] \
                    else p[s, P_MAXSPEED]
                ev.add("notifier" if winner else "no_candidate")
                if winner and best == len(cands) - 1:
                    ev.add("start_vehicle_wins")
                if winner and best == 0:
                    ev.add("end_vehicle_wins")
                speed = lv["speed"][b, s]
                out["exists"][i, l, k] = winner
                out["yield"][i, l, k] = _can_yield(
                    speed, p[s, P_MAXNEGACC], p[s, P_YIELD], p[s, P_LEN],
                    ndist)
                out["cleared"][i, l, k] = ndist + p[s, P_LEN] < 0
                out["cyc"][i, l, k] = lv["cyc"][b, s]
                out["dpos"][i, l, k] = ndist > 0
                out["dist"][i, l, k] = ndist
                out["reach"][i, l, k] = _reach(speed, ndist, target,
                                               p[s, P_USUALPOSACC], dt)
                out["ent"][i, l, k] = lv["enter_ll_time"][b, s] \
                    if winner else 0
                out["pri"][i, l, k] = lv["priority"][b, s] if winner else 0
                out["idx"][i, l, k] = bv if winner else -1
    return out, ev


@pytest.mark.parametrize("name", kc.NOTIFY_CASES)
def test_notify_plain_matches_reference_walk(name, ieee_sqrt):
    case = kc.notify_case(name)
    got = notify_cross.notify_cross(*kc.notify_args(case, "cpu"))
    B = case["leaves"]["dis"].shape[0]
    envs = [0, 1, B - 1] if B > 8 else None      # the walk is slow
    want, _ = walk(case, envs)
    for key in OUT:
        g = got[key].numpy()
        if envs is not None:
            g = g[envs]
        assert _bits_equal(g, want[key]) == 0, (name, key)


def test_notify_cases_reach_their_edges():
    """The cases cover B = 1, 3, 128 and 130, both float types, KC = 1 to
    20, k_link = 1 to 240 (the kernel's blocks of 8 and 16 threads: f64 at
    k_link 128 and 240, f32 at 218), and every edge of the rule: no candidate, each
    kind of winner, ties in front position, a tail at the cross distance
    on both sides of < and <=, e_ok failing by prev_drv, s_ok by veh_next
    and by ll_avail alone, NaN and -0.0 in dis, a link holding more than
    k_link vehicles."""
    seen = {"B": set(), "fp": set(), "KC": set(), "K": set()}
    union = set()
    for name, c in kc.notify_cases():
        B, K = c["leaves"]["dis"].shape[0], c["k_link"]
        seen["B"].add(B)
        seen["fp"].add(c["net"]["lnk_cross_d"].dtype)
        seen["KC"].add(c["net"]["lnk_cross_d"].shape[1])
        seen["K"].add(K)
        _, ev = walk(c, [0, B - 1])
        union |= ev
    assert seen["B"] == {1, 3, 128, 130}
    assert seen["fp"] == {np.dtype(np.float32), np.dtype(np.float64)}
    assert min(seen["KC"]) == 1 and max(seen["KC"]) == 20
    assert min(seen["K"]) == 1 and max(seen["K"]) >= 16
    assert {(128, np.float64), (240, np.float64), (218, np.float32)} <= {
        (c["k_link"], c["net"]["lnk_cross_d"].dtype.type)
        for _, c in kc.notify_cases()}
    want = {"no_candidate", "notifier", "start_vehicle_wins",
            "end_vehicle_wins", "tie_first_keeps", "end_tail_at_d",
            "link_tail_at_d",
            "e_ok_fails_by_prev", "s_ok_fails_by_next",
            "s_ok_fails_by_avail", "nan_dis", "neg0_dis", "link_over_k"}
    assert want <= union, want - union


def test_notify_cross_refuses_offsets_past_32_bits():
    """The kernel indexes with 32-bit offsets: the wrapper refuses a call
    whose B * V * NP (the params leaf), B * LL * KC or B * (D + 1) reaches
    2^31, on the CPU too (offsets_fit, which it calls before either
    branch), and takes the largest path's shapes."""
    for args in ((128, 2 ** 21, 12, 100, 20, 100),
                 (128, 1000, 12, 2 ** 20, 20, 100),
                 (2 ** 16, 10, 12, 10, 1, 2 ** 15)):
        with pytest.raises(ValueError, match="32-bit"):
            notify_cross.offsets_fit(*args)
    notify_cross.offsets_fit(128, 131072, 12, 32400, 20, 43560)


def test_arrange_link_table_is_compacted():
    """Each lanelink's first k_link vehicles as G3 reads them
    (sorted_idx at drv_off, arrange.link_rows) fill the first rows of
    JAX's link table, the empty rows (-1) after them, in G1's order;
    overflow_link holds where a link has more than k_link. Seeded pools
    where links hold 0 to more than k_link vehicles, B = 3."""
    rng = np.random.default_rng(11)
    B, V, L, LL, K = 3, 400, 20, 30, 4
    D = L + LL
    running = torch.as_tensor(rng.random((B, V)) < 0.8)
    drv = torch.as_tensor(rng.integers(0, D, (B, V)).astype(np.int32))
    dis = torch.as_tensor(rng.uniform(0.0, 50.0, (B, V)))
    seq = torch.as_tensor(rng.permutation(B * V).reshape(B, V)
                          .astype(np.int32))
    out = arrange.arrange(running, drv, dis, seq, D, L, K)
    lv = arrange.link_rows(out, L, LL, K).numpy()
    full = lv >= 0
    assert (full[..., 1:] <= full[..., :-1]).all()
    counts = full.sum(-1)
    assert counts.min() == 0 and counts.max() == K
    assert bool(out["overflow_link"].any())
    # the rows in G1's order: by drivable, then distance descending
    for b in range(B):
        for l in range(LL):
            on = np.nonzero(running[b].numpy() & (drv[b].numpy() == L + l))[0]
            order = on[np.lexsort((seq[b].numpy()[on], -dis[b].numpy()[on]))]
            want = np.full(K, -1)
            want[:min(K, on.size)] = order[:K]
            assert (lv[b, l] == want).all()
        assert bool(out["overflow_link"][b]) == any(
            int(((drv[b] == L + l) & running[b]).sum()) > K
            for l in range(LL))


def test_prev_drv_int_compare_equals_jax_float_cast_below_2_24():
    """G3's e_ok compares prev_drv as int32; the JAX package compares it
    cast to its float type and back (A_PREV of the pack). The two agree
    for every drivable index below 2^24 (and -1) in float32 and
    float64, and part just above it in float32."""
    x = torch.arange(-1, 2 ** 24 + 1, dtype=torch.int32)
    for f in (torch.float32, torch.float64):
        assert torch.equal(x.to(f).to(torch.int32), x)
    y = torch.tensor([2 ** 24 + 1], dtype=torch.int32)
    assert not torch.equal(y.to(torch.float32).to(torch.int32), y)
