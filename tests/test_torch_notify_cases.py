"""G3 notify_cross: the plain version against a numpy walk of the
reference's rule, on the seeded edge cases of
cityflow_tpu_torch/tools/kernel_cases.py (the cases chip_smoke.py holds
the CUDA kernel to on the card, bit for bit).

The walk restates Engine::threadNotifyCross (engine.cpp:317-372) cross
by cross, with Python loops: the candidates in order, the end lane's rear
vehicle while it is still on the lanelink (its tail before the cross,
strictly), the lanelink's vehicles from G1's table front to back (their
tail at or before the cross), the start lane's front vehicle when it is
about to enter (its next drivable is the lanelink, which is available);
the notifier is the first with the largest front position. Its
Cross::canPass terms (roadnet.cpp:604-660) follow: whether it exists, can
yield, has cleared the cross, is in a blocker cycle, has passed it, its
distance, reach steps, enter time, priority and slot; without a notifier
the terms come from the end lane's rear vehicle's pack (the plain
version's default index 0).
"""

import numpy as np
import pytest
import torch

from cityflow_tpu_torch.kernels import arrange, notify_cross
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_cross_cases import _can_yield, _reach
from test_torch_follow_cases import (  # noqa: F401 (ieee_sqrt: a fixture)
    _bits_equal, ieee_sqrt)

A_DIS, A_LEN, A_SPEED, A_MAXNEG, A_YIELD, A_UPA, A_TURNSPD, A_MAXSPD, \
    A_CYC, A_PREV = range(10)
OUT = ("exists", "yield", "cleared", "cyc", "dpos", "dist", "reach", "ent",
       "pri", "idx")


def _i32(x):
    """float -> int32 as torch's .to(int32) on the CPU (x86 truncation,
    INT_MIN out of range and for NaN)."""
    if np.isnan(x) or not -2.0 ** 31 <= x < 2.0 ** 31:
        return -2 ** 31
    return int(np.trunc(x))


def walk(c, envs=None):
    """The ten own-side tables, (B, LL, KC) each, and the edges met."""
    net, arr = c["net"], c["arr"]
    cd = net["lnk_cross_d"]
    LL, KC = cd.shape
    F = cd.dtype.type
    L, V = c["L"], c["fattrs"].shape[1]
    K = arr["link_veh"].shape[2]
    envs = range(c["fattrs"].shape[0]) if envs is None else envs
    out = {k: np.zeros((len(envs), LL, KC), bool) for k in OUT[:5]}
    out["dist"] = np.zeros((len(envs), LL, KC), F)
    for k in OUT[6:]:
        out[k] = np.zeros((len(envs), LL, KC), np.int32)
    ev = set()
    dt = net["interval"][()]
    for i, b in enumerate(envs):
        fa, ia = c["fattrs"][b], c["iattrs"][b]
        for l in range(LL):
            ll_len = net["drv_len"][L + l]
            last = arr["last_of"][b, net["ll_end"][l]]
            lfa = fa[min(max(last, 0), V - 1)]
            lia = ia[min(max(last, 0), V - 1)]
            first = arr["first_of"][b, net["ll_start"][l]]
            ffa = fa[min(max(first, 0), V - 1)]
            fia = ia[min(max(first, 0), V - 1)]
            e_ok = last >= 0 and _i32(lfa[A_PREV]) == L + l
            s_next = c["veh_next"][b, min(max(first, 0), V - 1)]
            s_ok = first >= 0 and s_next == L + l \
                and c["ll_avail"][b, l]
            if last >= 0 and not e_ok:
                ev.add("e_ok_fails_by_prev")
            if first >= 0 and not s_ok:
                ev.add("s_ok_fails_by_next" if s_next != L + l
                       else "s_ok_fails_by_avail")
            # (eligible at cross distance d, front position, pack, ints, slot)
            cands = [(lambda d, t=(ll_len + lfa[A_DIS]) - lfa[A_LEN]:
                      e_ok and t < d, ll_len + lfa[A_DIS], lfa, lia, last)]
            lv = arr["link_veh"][b, l]
            if any(lv[j] < 0 <= lv[j + 1] for j in range(K - 1)):
                ev.add("table_gap")
            for j in range(K):
                r = arr["link_fattr"][b, l, j]
                cands.append((lambda d, t=r[A_DIS] - r[A_LEN], ok=lv[j] >= 0:
                              ok and t <= d, r[A_DIS], r,
                              arr["link_iattr"][b, l, j], lv[j]))
                if lv[j] >= 0 and np.isnan(r[A_DIS]):
                    ev.add("nan_dis")
                if lv[j] >= 0 and r[A_DIS] == 0 and np.signbit(r[A_DIS]):
                    ev.add("neg0_dis")
            cands.append((lambda d: s_ok,
                          -(net["drv_len"][net["ll_start"][l]] - ffa[A_DIS]),
                          ffa, fia, first))
            for k in range(KC):
                d = cd[l, k]
                best_p, best = F(-1e30), 0
                winner = False
                for n, (elig, pk, *_rest) in enumerate(cands):
                    if elig(d) and pk > best_p:
                        best_p, best, winner = pk, n, True
                    elif elig(d) and pk == best_p and winner:
                        ev.add("tie_first_keeps")
                up, down = np.nextafter(d, np.inf), np.nextafter(d, -np.inf)
                if cands[0][0](up) and not cands[0][0](d):
                    ev.add("end_tail_at_d")          # tail < d: not at d
                if any(e(d) and not e(down) for e, *_ in cands[1:-1]):
                    ev.add("link_tail_at_d")         # tail <= d: at d
                _, _, bfa, bia, bv = cands[best]
                ndist = d - best_p
                target = bfa[A_TURNSPD] if net["ll_is_turn"][l] \
                    else bfa[A_MAXSPD]
                ev.add("notifier" if winner else "no_candidate")
                if winner and best == len(cands) - 1:
                    ev.add("start_vehicle_wins")
                if winner and best == 0:
                    ev.add("end_vehicle_wins")
                out["exists"][i, l, k] = winner
                out["yield"][i, l, k] = _can_yield(
                    bfa[A_SPEED], bfa[A_MAXNEG], bfa[A_YIELD], bfa[A_LEN],
                    ndist)
                out["cleared"][i, l, k] = ndist + bfa[A_LEN] < 0
                out["cyc"][i, l, k] = bfa[A_CYC] > 0
                out["dpos"][i, l, k] = ndist > 0
                out["dist"][i, l, k] = ndist
                out["reach"][i, l, k] = _reach(bfa[A_SPEED], ndist, target,
                                               bfa[A_UPA], dt)
                out["ent"][i, l, k] = bia[0] if winner else 0
                out["pri"][i, l, k] = bia[1] if winner else 0
                out["idx"][i, l, k] = bv if winner else -1
    return out, ev


@pytest.mark.parametrize("name", kc.NOTIFY_CASES)
def test_notify_plain_matches_reference_walk(name, ieee_sqrt):
    case = kc.notify_case(name)
    got = notify_cross.notify_cross(*kc.notify_args(case, "cpu"))
    B = case["fattrs"].shape[0]
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
    on both sides of < and <=, e_ok failing by A_PREV, s_ok by veh_next and
    by ll_avail alone, NaN and -0.0 in dis, gaps in the table."""
    seen = {"B": set(), "fp": set(), "KC": set(), "K": set()}
    union = set()
    for name, c in kc.notify_cases():
        B, LL, K = c["arr"]["link_veh"].shape
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
        (c["arr"]["link_veh"].shape[2], c["net"]["lnk_cross_d"].dtype.type)
        for _, c in kc.notify_cases()}
    want = {"no_candidate", "notifier", "start_vehicle_wins",
            "end_vehicle_wins", "tie_first_keeps", "end_tail_at_d",
            "link_tail_at_d",
            "e_ok_fails_by_prev", "s_ok_fails_by_next",
            "s_ok_fails_by_avail", "nan_dis", "neg0_dis", "table_gap"}
    assert want <= union, want - union


def test_notify_cross_refuses_offsets_past_32_bits():
    """The kernel indexes with 32-bit offsets: the wrapper refuses a call
    whose B * V * NA, B * LL * k_link * NA, B * LL * KC or B * D reaches
    2^31, on the CPU too (offsets_fit, which it calls before either
    branch), and takes the largest path's shapes."""
    for args in ((128, 2 ** 21, 10, 100, 16, 20, 100),
                 (128, 1000, 10, 2 ** 17, 16, 20, 100),
                 (128, 1000, 10, 2 ** 20, 1, 20, 100),
                 (2 ** 16, 10, 10, 10, 1, 1, 2 ** 16)):
        with pytest.raises(ValueError, match="32-bit"):
            notify_cross.offsets_fit(*args)
    notify_cross.offsets_fit(128, 131072, 10, 32400, 16, 20, 43560)


def test_arrange_link_table_is_compacted():
    """G1's lanelink table holds each link's first k_link vehicles in its
    first rows, the empty rows (-1) after them: G3's bound counts the rows
    up to the first empty one. Seeded pools where links hold 0 to more
    than k_link vehicles, B = 3."""
    rng = np.random.default_rng(11)
    B, V, L, LL, K = 3, 400, 20, 30, 4
    D = L + LL
    running = torch.as_tensor(rng.random((B, V)) < 0.8)
    drv = torch.as_tensor(rng.integers(0, D, (B, V)).astype(np.int32))
    dis = torch.as_tensor(rng.uniform(0.0, 50.0, (B, V)))
    seq = torch.as_tensor(rng.permutation(B * V).reshape(B, V)
                          .astype(np.int32))
    fa = torch.as_tensor(rng.uniform(0.0, 9.0, (B, V, 10)))
    ia = torch.as_tensor(rng.integers(0, 9, (B, V, 2)).astype(np.int32))
    out = arrange.arrange(running, drv, dis, seq, D, L, K, fa, ia)
    lv = out["link_veh"].numpy()
    full = lv >= 0
    assert (full[..., 1:] <= full[..., :-1]).all()
    counts = full.sum(-1)
    assert counts.min() == 0 and counts.max() == K
    assert bool(out["overflow_link"].any())
