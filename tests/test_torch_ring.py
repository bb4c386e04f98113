"""The PyTorch ring step (cityflow_tpu_torch.core.ring) against the JAX
package's, on config_4x4.json, on the CPU (every kernel wrapper takes its
plain PyTorch version there).

Per phase, each step starts from JAX's state: integer and bool leaves and
`mid` entries must be equal, float32 ones within 1e-5 absolute. The float
leaves that are not bitwise differ by one ulp where XLA turns a division
by a compile-time constant (the template's decelerations) into a
multiplication by its reciprocal and the port divides (ROADMAP.md queue 3).
"""

import dataclasses
import os

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

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "fixtures", "config_4x4.json")
F32_TOL = 1e-5


def jax_leaves(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)
            if getattr(st, f.name) is not None}


def port_leaves(st):
    return {k: v.numpy() for k, v in st.leaves().items()}


def build_pair(config, steps, skc=None):
    jsim = jax_ring_sim.build_sim(jax_compile(config), horizon=steps + 8,
                                  skc=skc)
    tsim = ring_sim.build_sim(compile_scenario(config), horizon=steps + 8,
                              skc=skc, device="cpu")
    return jsim, tsim


def assert_close(name, want, got, bitwise_log=None):
    want = np.asarray(want)
    got = np.asarray(got)
    assert want.shape == got.shape, f"{name}: {want.shape} vs {got.shape}"
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=name)
        return
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=0, atol=F32_TOL,
                               err_msg=name)
    if bitwise_log is not None and not np.array_equal(
            got.astype(np.float32), want.astype(np.float32), equal_nan=True):
        bitwise_log.add(name)


def vehicles(leaves):
    """{key: (drivable, dis, speed)} from ring state leaves (lanes are
    ('l', pos), links ('k', pos)). The key is the uid; with lane change
    (an l_sh leaf) it is (uid, shadow), since a shadow shares its real's
    uid."""
    out = {}
    sh = leaves.get("l_sh")
    for pre, n in (("l", leaves["n_l"]), ("k", leaves["n_k"])):
        uid, dis, spd = (leaves[f"{pre}_uid"], leaves[f"{pre}_dis"],
                         leaves[f"{pre}_speed"])
        for p in np.nonzero(n)[0]:
            for s in range(int(n[p])):
                key = int(uid[s, p])
                if sh is not None:
                    key = (key, pre == "l" and bool(sh[s, p]))
                out[key] = ((pre, int(p)), float(dis[s, p]),
                            float(spd[s, p]))
    return out


@pytest.fixture(scope="module")
def pair40():
    return build_pair(CONFIG, 40)


@pytest.fixture(scope="module")
def jax_run40(pair40):
    """JAX's 40 steps, phase by phase: for each step the state it starts
    from, p1's (rs, mid) and p2's state."""
    jsim, _ = pair40
    run, st = [], jsim.state
    for _ in range(40):
        rs1, mid = jax_ring.ring_step_p1(jsim.tables, jsim.cfg, st, jsim.q)
        st2 = jax_ring.ring_step_p2(jsim.tables, jsim.cfg, rs1, mid)
        run.append((st, rs1, mid, st2))
        st = st2
    return run


def test_per_phase_matches_jax_40_steps(pair40, jax_run40):
    _, tsim = pair40
    not_bitwise = set()
    for t, (st, rs1, mid, st2) in enumerate(jax_run40):
        trs1, tmid = ring.ring_step_p1(
            tsim.tables, tsim.cfg, ring_state_from_numpy(jax_leaves(st), "cpu"),
            tsim.q)
        for k, v in jax_leaves(rs1).items():
            assert_close(f"step {t} p1 {k}", v, getattr(trs1, k).numpy(),
                         not_bitwise)
        assert set(mid) == set(tmid)
        for k, v in mid.items():
            assert_close(f"step {t} mid {k}", v, tmid[k].numpy(),
                         not_bitwise)
        tst2 = ring.ring_step_p2(
            tsim.tables, tsim.cfg, ring_state_from_numpy(jax_leaves(rs1), "cpu"),
            mid_from_numpy(mid, "cpu"))
        for k, v in jax_leaves(st2).items():
            assert_close(f"step {t} p2 {k}", v, getattr(tst2, k).numpy(),
                         not_bitwise)
    st = jax_run40[-1][3]
    n = int(np.asarray(st.n_l).sum() + np.asarray(st.n_k).sum())
    assert n > 50, "the fixture should have traffic by step 40"
    # recorded: which float leaves were not bitwise over these 40 steps
    fields = sorted({name.split()[-1] for name in not_bitwise})
    print("float leaves not bitwise over 40 steps:", fields or "none")
    assert set(fields) <= {"ap_spd", "ap_dis", "new_spd_l", "new_dis_l",
                           "ns_k3", "nd_k3", "l_dis", "l_speed", "k_dis",
                           "k_speed"}


def test_kernel_plain_versions_match_jax_intermediates(pair40, jax_run40):
    """Each kernel's plain version at the 4x4 call-site shapes against the
    JAX intermediate it replaces (ring_step debug / mid), from JAX's state
    after 30 steps."""
    jsim, tsim = pair40
    st, _, mid, _ = jax_run40[30]
    jnew, jdbg = jax_ring.ring_step(jsim.tables, jsim.cfg, st, jsim.q,
                                    debug=True)
    tst = ring_state_from_numpy(jax_leaves(st), "cpu")
    new, dbg = ring.ring_step(tsim.tables, tsim.cfg, tst, tsim.q, debug=True)
    sq = lambda x: x[..., 0].numpy()
    cfg = tsim.cfg
    R = min(cfg.SKC, cfg.SK)
    # K1: the forward exchange is mid["inl"]
    assert_close("K1 inl", mid["inl"], sq(dbg["mid"]["inl"]))
    # K2 on link rows: mid k_fail / k_fffoe rows [:R]
    af, _, ffo = dbg["k2_link"]
    LPI, G = cfg.LPI, cfg.G
    assert_close("K2 any_fail", np.asarray(mid["k_fail"])[:R],
                 sq(af).reshape(R, LPI, G))
    assert_close("K2 ff_foe", np.asarray(mid["k_fffoe"])[:R],
                 sq(ffo).reshape(R, LPI, G))
    # K2 on approach rows: ap_ffo is the raw output, ap_fail is masked
    # by the rows' relevance
    _, _, ffo_ap = dbg["k2_ap"]
    assert_close("K2 ap_ffo", mid["ap_ffo"], sq(ffo_ap))
    assert_close("K2 ap_fail", mid["ap_fail"], sq(dbg["mid"]["ap_fail"]))
    # K3 on link rows: ns_k3 and nd_k3 = k_dis + delta
    ns, dd = dbg["k3_link"]
    assert_close("K3 link speed", mid["ns_k3"], sq(ns))
    kdis = np.asarray(st.k_dis, np.float32).reshape(
        np.asarray(mid["nd_k3"]).shape)
    assert_close("K3 link dis", mid["nd_k3"], kdis + sq(dd))
    # K3 on approach rows: ap_spd
    assert_close("K3 approach speed", mid["ap_spd"], sq(dbg["k3_ap"][0]))
    # K3 on lane rows + front overrides: new_dis_l / new_spd_l
    assert_close("K3 lane speed", mid["new_spd_l"], sq(dbg["k3_lane"][0]))
    assert_close("commit new_dis_l", jdbg["new_dis_l"], sq(dbg["new_dis_l"]))
    # K4: the committed rings and the counts feeding them
    for k in ("x_l", "x_k", "m_k", "m_l"):
        assert_close(f"K4 {k}", jdbg[k], sq(dbg[k]))
    jnew = jax_leaves(jnew)
    for k in ("l_dis", "l_speed", "l_uid", "l_pri", "l_last", "l_prev",
              "l_nxt", "l_nxt3", "k_dis", "k_uid", "k_pri", "k_entll",
              "k_nxtl", "n_l", "n_k"):
        assert_close(f"K4 {k}", jnew[k], new.leaves()[k].numpy())


def test_route_rows_above_the_transfer_cap_match_a_direct_lookup():
    """More link->lane transfers in one step than the JAX step's 1024-row
    compaction cap (cityflow_tpu/core/ring.py:1598): every link of the 4x4
    grid holds XK vehicles on random routes, and all of them cross the
    link end (the notify phase's new distances are set past it). The port
    gathers the route rows of every transfer; each lane candidate's nxt /
    nxt3 / last payload must equal a direct numpy lookup of route_next /
    route_aux at its vehicle's (route, rpos + 1, end lane's local index)."""
    tsim = ring_sim.build_sim(compile_scenario(CONFIG), horizon=8,
                              device="cpu")
    net = tsim.tables
    XK = min(tsim.cfg.XK, tsim.cfg.SK)
    # no per-intersection cut either: every transfer is gathered
    cfg = dataclasses.replace(tsim.cfg, TI=XK * tsim.cfg.LPI)
    SK, LKp = cfg.SK, cfg.LKp
    rn = net["route_next"].numpy()
    aux = net["route_aux"].numpy()
    NR, RLEN, MAXLPR = rn.shape
    lk_len = net["lk_len"].numpy()
    rng = np.random.default_rng(0)
    route = np.zeros((SK, LKp), np.int32)
    rpos = np.zeros((SK, LKp), np.int32)
    route[:XK] = rng.integers(0, NR, (XK, LKp))
    rpos[:XK] = rng.integers(0, RLEN - 1, (XK, LKp))
    dis = np.zeros((SK, LKp), np.float32)
    dis[:XK] = lk_len[None] - 1.0 - 8.0 * np.arange(XK)[:, None]
    uid = np.full((SK, LKp), -1, np.int32)
    uid[:XK] = np.arange(XK * LKp).reshape(XK, LKp)
    T = lambda a: torch.as_tensor(a)[..., None].contiguous()
    st = ring.batch_ring_state(tsim.state, 1).replace_fields(
        n_k=T(np.full(LKp, XK, np.int32)), k_route=T(route),
        k_rpos=T(rpos), k_dis=T(dis), k_speed=T(np.where(uid >= 0, 10.0, 0.0)
                                               .astype(np.float32)),
        k_uid=T(uid))
    rs1, mid, _ = ring._notify_phase(net, cfg, st, tsim.q)
    nd = mid["nd_k3"].reshape(SK, LKp, 1).clone()
    nd[:XK] = torch.as_tensor(lk_len)[None, :, None] + 1.0 \
        + torch.arange(XK, 0, -1)[:, None, None]
    mid = dict(mid, nd_k3=nd.reshape(mid["nd_k3"].shape))
    _, dbg = ring._commit_phase(net, cfg, rs1, mid, debug=True)
    cands = dbg["cands"][..., 0].numpy()        # (KIN * XK, PCH, OL * G)
    llocal = net["ln_llocal"].numpy()
    end_local = llocal[net["lk_end_lane"].numpy()]
    app = net["app_src_g"].numpy()
    checked = 0
    for kin in range(cfg.KIN):
        for xs in range(XK):
            c = cands[kin * XK + xs]
            for j in np.nonzero(c[13] > 0.5)[0]:      # valid candidates
                r = app[kin, j]
                g = ((route[xs, r] * RLEN + min(rpos[xs, r] + 1, RLEN - 1))
                     * MAXLPR + min(max(end_local[r], 0), MAXLPR - 1))
                a = int(aux.reshape(-1)[g])
                assert c[9, j] == rn.reshape(-1)[g], (kin, xs, j)
                assert c[10, j] == (a >> 1) - 2, (kin, xs, j)
                assert c[11, j] == (a & 1), (kin, xs, j)
                checked += 1
    assert checked == XK * LKp > 1024, checked
