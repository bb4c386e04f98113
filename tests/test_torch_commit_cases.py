"""K4 ring_commit and T1 tpl_params: the plain versions against a slot-by-
slot numpy walk written here, on the seeded edge cases of
cityflow_tpu_torch/tools/kernel_cases.py (the cases chip_smoke.py holds
the CUDA kernels to, bit for bit, on the card).

The walk reads the JAX functions' semantics directly (cityflow_tpu/core/
ring.py :1644-1907 and _PP :270-297): per (column, env), slot s takes slot
s + x for x in 1..XK (any other x shifts by 0) or, in the lane-change
mode, the kept slot of rank s while at most XD slots above it are deleted;
the fill past the end; the taken candidates (the first nsel in order, or
stably sorted by distance descending, valid first) that are valid land at
base, base + 1, ... below S. Values are compared as bits.
"""

import numpy as np
import pytest
import torch

from cityflow_tpu_torch.kernels import ring_commit, tpl_params
from cityflow_tpu_torch.tools import kernel_cases as kc

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def _sat(v):
    """XLA's float32 -> int32: saturate, NaN -> 0, truncate."""
    v = np.asarray(v, np.float32).astype(np.float64)
    out = np.where(np.isnan(v), 0.0, np.trunc(np.nan_to_num(v)))
    out = np.where(v >= 2.0 ** 31, I32_MAX, np.where(v < -2.0 ** 31, I32_MIN,
                                                     out))
    return out.astype(np.int64).astype(np.int32)


def _as_kind(v, v2, kind):
    """A float32 entrant value (v2: the low half of a priority) as the
    ring's dtype."""
    if kind == "f32":
        return np.asarray(v, np.float32)
    if kind == "bool":
        return np.asarray(v, np.float32) > 0.5
    if kind == "i32":
        return _sat(v)
    hi = _sat(v).astype(np.uint32) << np.uint32(16)
    return (hi | _sat(v2).astype(np.uint32)).view(np.int32)


def _sources(case, S, N, B):
    """(S, N, B) int: the slot each output slot reads, -1 for the fill."""
    src = np.full((S, N, B), -1, np.int64)
    dmask = case.get("dmask")
    for n in range(N):
        for b in range(B):
            if dmask is not None:
                k = ndel = 0
                for t in range(S):
                    if dmask[t, n, b]:
                        ndel += 1
                    elif ndel <= case["XD"]:
                        src[k, n, b] = t
                        k += 1
            else:
                x = int(case["x"][n, b])
                x = x if 1 <= x <= case["XK"] else 0
                for s in range(S - x):
                    src[s, n, b] = s + x
    return src


def _entrants(case, N, B):
    """[(slot, n, b, candidate, entrant column)] of every placed entrant."""
    app, S = case["app"], case["chans"][0][0].shape[0]
    A = app.shape[0]
    placed = []
    for n in range(N):
        if case["app_I"]:
            g = n % case["app_I"]
            if g >= case["app_G"]:
                continue
            ac = (n // case["app_I"]) * case["app_G"] + g
        else:
            ac = n
        for b in range(B):
            valid = [bool(app[c, case["valid_ch"], ac, b] > 0.5)
                     for c in range(A)]
            if case["sort_ch"] >= 0:
                key = [-float(app[c, case["sort_ch"], ac, b]) if valid[c]
                       else np.inf for c in range(A)]
                order = sorted(range(A), key=lambda c: (key[c], c))
            else:
                order = list(range(A))
            k = 0
            for c in order[:case["nsel"]]:
                if valid[c]:
                    s = int(case["base"][n, b]) + k
                    k += 1
                    if 0 <= s < S:
                        placed.append((s, n, b, c, ac))
    return placed


def walk_commit(case):
    """Every channel's committed ring, slot by slot."""
    upd0 = case["chans"][0][0]
    S, N, B = upd0.shape
    src = _sources(case, S, N, B)
    placed = _entrants(case, N, B)
    outs = []
    for upd, kind, fill, app_ch, app_ch2 in case["chans"]:
        fillv = _as_kind(np.float32(fill), np.float32(fill), kind)
        out = np.where(src >= 0, np.take_along_axis(upd, src.clip(0), 0),
                       fillv).astype(upd.dtype)
        for s, n, b, c, ac in placed:
            v = case["envval"][b] if app_ch < 0 else \
                case["app"][c, app_ch, ac, b]
            out[s, n, b] = _as_kind(v, case["app"][c, app_ch2, ac, b], kind)
        outs.append(out)
    return outs


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", kc.COMMIT_CASES)
def test_ring_commit_plain_matches_the_slot_walk(name):
    case = kc.commit_case(name)
    args, kw = kc.commit_args(case, "cpu")
    got = ring_commit.ring_commit(*args, **kw)
    want = walk_commit(case)
    mode, B, kw = kc.COMMIT_SPECS[name]
    assert len(got) == len(want) == kw.get("nch", kc.MAX_CH)
    S, N, B = case["chans"][0][0].shape
    assert (S, B) == (kw.get("S", 128), B)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.as_tensor(w).dtype, i
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                      err_msg=f"{name} channel {i}")
    # the case holds what it says: entrants placed, past-app_G columns and
    # all-invalid columns without any, ties among the valid keys
    placed = _entrants(case, N, B)
    assert placed
    assert not any(n % 4 == 3 for _, n, _, _, _ in placed) \
        or not case["app_I"]
    assert not any(ac == 0 for _, _, _, _, ac in placed)
    if case["sort_ch"] >= 0:
        keys = case["app"][:, case["sort_ch"]]
        ok = case["app"][:, case["valid_ch"]] > 0.5
        assert any(len(set(keys[ok[:, a, b], a, b].tolist()))
                   < int(ok[:, a, b].sum())
                   for a in range(keys.shape[1]) for b in range(B))
    if case.get("dmask") is not None:
        dels = np.cumsum(case["dmask"], 0) - case["dmask"]
        assert (dels[~case["dmask"]] > case["XD"]).any()   # drops by the cap


def walk_tpl(case):
    """(ncols, *view shape) float32: each element's template parameters."""
    idx = kc.TPL_VIEWS[case["view"]](case["base"])
    table, TP = case["table"], case["TP"]
    out = np.zeros((len(case["cols"]),) + idx.shape, np.float32)
    flat = idx.reshape(-1)
    for c, col in enumerate(case["cols"]):
        oc = out[c].reshape(-1)
        for e, t in enumerate(flat):
            if 0 <= t < TP:
                oc[e] = table[t, col]
        out[c] = oc.reshape(idx.shape)
    return out


@pytest.mark.parametrize("name", list(kc.TPL_CASES))
def test_tpl_params_plain_matches_the_walk(name):
    case = kc.tpl_case(name)
    tpl, table, cols = kc.tpl_args(case, "cpu")
    got = tpl_params.tpl_params(tpl, table, cols)
    want = walk_tpl(case)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32), err_msg=name)
    # the view the case names: one element in (not 16-byte aligned) where
    # it says so
    assert tpl.is_contiguous()
    assert (tpl.storage_offset() == 1) == (case["view"] == "offset1")
    bad = (case["base"] < 0) | (case["base"] >= case["TP"])
    assert bad.any() and (~bad).any()


def test_tpl_params_refuses_a_strided_index():
    tpl = torch.zeros((6, 8), dtype=torch.int32)
    table = torch.ones((3, 12))
    with pytest.raises(ValueError, match="not contiguous"):
        tpl_params.tpl_params(tpl[:, ::2], table, (0, 1))


def test_ring_commit_refuses_a_delete_cap_past_max_xd():
    S = ring_commit.MAX_XD + 2
    upd = torch.zeros((S, 1, 1))
    app = torch.zeros((1, 2, 1, 1))
    base = torch.zeros((1, 1), dtype=torch.int32)
    dmask = torch.zeros((S, 1, 1), dtype=torch.bool)
    for XD, ok in ((ring_commit.MAX_XD, True), (ring_commit.MAX_XD + 1,
                                                False)):
        call = lambda: ring_commit.ring_commit(
            [(upd, "f32", 0.0, 1, 1)], None, base, app, valid_ch=0,
            sort_ch=-1, nsel=1, XK=2, dmask=dmask, XD=XD)
        if ok:
            assert torch.equal(call()[0], upd)
        else:
            with pytest.raises(ValueError, match="XD"):
                call()
