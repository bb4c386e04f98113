"""G1 arrange and G7 lc_plan's yield mode: the plain versions against the
JAX package's `arrangement` and `yield_speed` (vmapped over the envs,
jitted under x64), bitwise, on the seeded edge cases of
cityflow_tpu_torch/tools/kernel_cases.py (the cases chip_smoke.py holds
the CUDA kernels to on the card, bit for bit).

G1 returns drv_off in place of JAX's link tables: each table is rebuilt
from sorted_idx at drv_off (arrange.link_rows) and the leaves, and held
to JAX's. Slots that are not running follow the running ones in slot
order with leader -1 (JAX orders them by their stale list_seq and chains
them as leaders; nothing reads those)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cityflow_tpu.core import lanechange as jlc
from cityflow_tpu.core import step as js

from cityflow_tpu_torch.kernels import arrange, lc_plan
from cityflow_tpu_torch.tools import kernel_cases as kc
from test_torch_follow_cases import ieee_sqrt  # noqa: F401 (a fixture)


def _jax_arrangement(case):
    """JAX's arrangement of every env of the case, with link_veh and
    link_dis (vmapped)."""
    B, V = case["running"].shape
    cfg = SimpleNamespace(max_vehicles=V, num_drivables=case["D"],
                          num_lanes=case["L"], k_link=case["k_link"])

    def one(running, drv, dis, list_seq):
        a = js.arrangement(None, cfg, running, drv, dis, list_seq,
                           jnp.zeros_like(dis))
        return {k: a[k] for k in ("leader", "first_of", "last_of",
                                  "sorted_idx", "sorted_drv",
                                  "overflow_link", "link_veh", "link_dis")}
    out = jax.jit(jax.vmap(one))(*(jnp.asarray(case[k]) for k in (
        "running", "drv", "dis", "list_seq")))
    return {k: np.asarray(v) for k, v in out.items()}


def _eq(name, got, want):
    """Bit for bit (floats: a NaN against any NaN), dtypes equal."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (name, got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        it = np.int64 if got.itemsize == 8 else np.int32
        same = (got.view(it) == want.view(it)) | (np.isnan(got)
                                                  & np.isnan(want))
    else:
        same = got == want
    bad = int((~same).sum())
    assert bad == 0, f"{name}: {bad} values differ"


@pytest.mark.parametrize("name", kc.ARRANGE_CASES)
def test_arrange_plain_matches_jax(name):
    case = kc.arrange_case(name)
    got = arrange.arrange(*kc.arrange_args(case, "cpu"))
    want = _jax_arrangement(case)
    run = case["running"]
    D, L, K = case["D"], case["L"], case["k_link"]
    g = {k: v.numpy() for k, v in got.items()}
    for b in range(run.shape[0]):
        n = int(run[b].sum())
        _eq(f"leader[{b}]", g["leader"][b][run[b]], want["leader"][b][run[b]])
        assert (g["leader"][b][~run[b]] == -1).all()
        _eq(f"sorted_idx[{b}]", g["sorted_idx"][b, :n],
            want["sorted_idx"][b, :n])
        assert (g["sorted_idx"][b, n:] == np.nonzero(~run[b])[0]).all()
        _eq(f"drv_off[{b}]", g["drv_off"][b], np.searchsorted(
            want["sorted_drv"][b, :n], np.arange(D + 1)).astype(np.int32))
    for k in ("first_of", "last_of", "overflow_link"):
        _eq(k, g[k], want[k])
    LL = max(D - L, 1)
    rows = arrange.link_rows(got, L, LL, K).numpy()
    _eq("link_veh", rows, want["link_veh"])
    dis = np.take_along_axis(case["dis"], np.clip(rows, 0, None).reshape(
        rows.shape[0], -1), 1).reshape(rows.shape)
    _eq("link_dis", np.where(rows >= 0, dis, 0), want["link_dis"])


def test_arrange_cases_reach_their_edges():
    """B = 1, 3, 128 and 130; both float types; ties in -dis and in
    list_seq among a drivable's vehicles; -0.0 against +0.0 and NaN in
    the same drivable; a drivable longer than a rank block (256) and a
    warp; a lanelink with exactly k_link vehicles and one with k_link +
    1 (overflow) where no other overflows; empty drivables; an env that
    runs nothing; V not a multiple of the 1024-slot tile."""
    seen = set()
    Bs, fps = set(), set()
    for name, c in kc.arrange_cases():
        run, drv, dis, ls = c["running"], c["drv"], c["dis"], c["list_seq"]
        B, V = run.shape
        D, L, K = c["D"], c["L"], c["k_link"]
        Bs.add(B)
        fps.add(dis.dtype)
        if V % 1024:
            seen.add("V_off_tile")
        for b in range(B):
            if not run[b].any():
                seen.add("idle_env")
            cnt = np.bincount(drv[b][run[b]], minlength=D)
            if (cnt == 0).any():
                seen.add("empty_drivable")
            if cnt.max() > 256:
                seen.add("bucket_past_block")
            over = cnt[L:] > K
            if over.sum() == 1 and (cnt[L:] == K).any():
                seen.add("exact_k_and_overflow")
            for d in np.nonzero(cnt >= 2)[0]:
                on = run[b] & (drv[b] == d)
                x, s = dis[b][on], ls[b][on]
                if np.unique(x[~np.isnan(x)]).size < (~np.isnan(x)).sum():
                    seen.add("dis_tie")
                key = np.stack([x.view(np.int64 if x.dtype == np.float64
                                       else np.int32), s])
                if np.unique(key, axis=1).shape[1] < x.size:
                    seen.add("dis_and_seq_tie")
                zero = x == 0
                if (zero & np.signbit(x)).any() and (zero & ~np.signbit(x)
                                                      ).any():
                    seen.add("neg0_pos0")
                if np.isnan(x).any():
                    seen.add("nan")
    assert Bs == {1, 3, 128, 130}
    assert fps == {np.dtype(np.float32), np.dtype(np.float64)}
    want = {"V_off_tile", "idle_env", "empty_drivable", "bucket_past_block",
            "exact_k_and_overflow", "dis_tie", "dis_and_seq_tie",
            "neg0_pos0", "nan"}
    assert want <= seen, want - seen


def _jax_yield(case):
    """JAX's yield_speed of every env of the case (vmapped), op by op:
    jitted, XLA folds 0.5 / (0.5 / maxNegAcc) into maxNegAcc, which
    rounds apart from the reference's two divisions on jittered
    params."""
    cfg = SimpleNamespace(interval=float(case["interval"]))

    def one(speed, params, recv, fgap, tl, tf):
        st = SimpleNamespace(speed=speed, params=params, lc_recv=recv,
                             lc_fgap=fgap, lc_tleader=tl, lc_tfollower=tf,
                             dis=speed)
        return jlc.yield_speed(None, cfg, st)
    with jax.disable_jit():
        return np.asarray(jax.vmap(one)(*(jnp.asarray(case[k]) for k in (
            "speed", "params", "lc_recv", "lc_fgap", "lc_tleader",
            "lc_tfollower"))))


@pytest.mark.parametrize("name", kc.YIELD_CASES)
def test_yield_plain_matches_jax(name, ieee_sqrt):
    case = kc.yield_case(name)
    st, net = kc.yield_args(case, "cpu")
    got = lc_plan.lc_plan("yield", st, net, 1).numpy()
    _eq("yield", got, _jax_yield(case))


def test_yield_cases_reach_their_edges():
    """No receiver, every slot a receiver, a sender that is its
    receiver's target leader (no cap), a sender whose target follower is
    -1, a negative cap that becomes 100, B = 1, 3, 128 and 130, both
    float types, rows that start off a 16-byte word."""
    seen, Bs, fps = set(), set(), set()
    for name, c in kc.yield_cases():
        recv, tl, tf = c["lc_recv"], c["lc_tleader"], c["lc_tfollower"]
        B, V = recv.shape
        Bs.add(B)
        fps.add(c["speed"].dtype)
        if (recv < 0).all():
            seen.add("no_receiver")
        if (recv >= 0).all():
            seen.add("every_receiver")
        if V % 4:
            seen.add("off_word")
        st, net = kc.yield_args(c, "cpu")
        y = _jax_yield(c)
        for b in range(B):
            on = recv[b] >= 0
            src = recv[b][on]
            me = np.nonzero(on)[0]
            if (tl[b][src] == me).any():
                seen.add("sender_leads_receiver")
            lead = tl[b][src] == me
            if ((tf[b][src] < 0) & ~lead).any():
                seen.add("no_target_follower")
            if ((y[b][on] == 100) & ~lead).any():
                seen.add("negative_cap_is_100")
    assert Bs == {1, 3, 128, 130}
    assert fps == {np.dtype(np.float32), np.dtype(np.float64)}
    want = {"no_receiver", "every_receiver", "sender_leads_receiver",
            "no_target_follower", "negative_cap_is_100", "off_word"}
    assert want <= seen, want - seen
