"""The port's scenario compiler against the JAX package's: ring tables,
spawn queues and the initial ring state equal leaf for leaf, exactly; and
every gather index table selects exactly what its one-hot einsum does."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from cityflow_tpu import ring_sim as jax_ring_sim
from cityflow_tpu.compiler.net import compile_scenario as jax_compile
from cityflow_tpu.compiler.ring_net import build_ring as jax_build_ring
from cityflow_tpu.tools import gridgen as jax_gridgen

from cityflow_tpu_torch import ring_sim
from cityflow_tpu_torch.compiler.net import compile_scenario
from cityflow_tpu_torch.compiler.ring_net import build_ring, index_tables
from cityflow_tpu_torch.tools import gridgen
from test_torch_ring import jax_leaves, port_leaves

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _fix(name):
    return os.path.join(HERE, "fixtures", name)


def _assert_same_scenario(cfg_jax, cfg_port, horizon, monkeypatch):
    jnet, tnet = jax_compile(cfg_jax), compile_scenario(cfg_port)
    jtb, jmeta = jax_build_ring(jnet, 1.0)
    ttb, tmeta = build_ring(tnet, 1.0)
    # each build_sim below takes these tables instead of building them again
    monkeypatch.setattr(jax_ring_sim, "build_ring", lambda *a: (jtb, jmeta))
    monkeypatch.setattr(ring_sim, "build_ring", lambda *a: (ttb, tmeta))
    assert set(jtb) <= set(ttb)
    for k, v in jtb.items():
        a, b = np.asarray(v), np.asarray(ttb[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("I", "G", "T", "LPI", "OL", "IL", "KC", "KIN", "KOUT", "LNp",
              "LKp", "type_ranges", "TP", "foe_via_perm"):
        assert getattr(jmeta, k) == getattr(tmeta, k), k
    for k in ("lane_pos", "pos_lane", "link_pos", "pos_link",
              "entry_lanes", "new2old_inter"):
        assert np.array_equal(getattr(jmeta, k), getattr(tmeta, k)), k
    jsim = jax_ring_sim.build_sim(jnet, horizon=horizon, sl=40)
    tsim = ring_sim.build_sim(tnet, horizon=horizon, sl=40, device="cpu")
    for k, v in jsim.q.items():
        assert np.array_equal(np.asarray(v), tsim.q[k].numpy()), f"q {k}"
    tl = port_leaves(tsim.state)
    for k, v in jax_leaves(jsim.state).items():
        assert v.dtype == tl[k].dtype and np.array_equal(v, tl[k]), k
    return ttb, tmeta


@pytest.mark.parametrize("config", ["config_4x4.json", "config_2x2.json"])
def test_tables_queues_and_state_equal_jax(config, monkeypatch):
    _assert_same_scenario(_fix(config), _fix(config), 64, monkeypatch)


def test_30x30_grid_equals_jax(tmp_path, monkeypatch):
    """Each package's gridgen regenerates the benchmark roadnet; the files,
    tables, queues and initial state come out identical."""
    out = {}
    for name, gen in (("jax", jax_gridgen), ("port", gridgen)):
        d = tmp_path / name
        d.mkdir()
        gen.main(["30", "30", "--dir", str(d) + "/", "--roadnetFile",
                  "roadnet.json", "--flowFile", "flow_generated.json"])
        shutil.copy(os.path.join(ROOT, "benchmarks", "flow_30_30.json"),
                    d / "flow.json")
        with open(os.path.join(ROOT, "benchmarks", "config_30x30.json")) as f:
            cfgj = json.load(f)
        cfgj.update(dir=str(d) + "/", roadnetFile="roadnet.json",
                    flowFile="flow.json")
        (d / "config.json").write_text(json.dumps(cfgj))
        out[name] = d
    assert (out["jax"] / "roadnet.json").read_bytes() == \
        (out["port"] / "roadnet.json").read_bytes()
    ttb, meta = _assert_same_scenario(str(out["jax"] / "config.json"),
                                      str(out["port"] / "config.json"), 16,
                                      monkeypatch)
    assert (meta.I, meta.G, meta.LPI, meta.KC, meta.LNp, meta.LKp) == \
        (1020, 900, 36, 20, 12240, 32400)
    _assert_index_tables_gather_like_einsums(ttb, meta)


def _assert_index_tables_gather_like_einsums(tb, meta):
    """x through each index table == the JAX one-hot einsum on x."""
    rng = np.random.default_rng(1)
    G, I, T = meta.G, meta.I, meta.T
    ix = index_tables(tb, meta.type_ranges, G, I)

    def gather(x_rows, idx):                       # (N, C) rows, (J,) index
        return np.where((idx >= 0)[:, None], x_rows[np.clip(idx, 0, None)],
                        np.float32(0))

    def typed_mm(E, x):                            # E (T, A, Bd), x (Bd, G)
        out = [E[t] @ x[:, g0:g1] for t, (g0, g1) in
               enumerate(meta.type_ranges)]
        return np.concatenate(out, axis=1)

    C = 3
    E_el = np.asarray(tb["E_el"])
    x = rng.standard_normal((E_el.shape[1], C)).astype(np.float32)
    np.testing.assert_array_equal(gather(x, ix["el_src"]), E_el @ x)
    for name, src, rows, stride_view in (
            ("E_start", "start_src", meta.IL, None),
            ("E_rl", "rl_src", tb["E_rl"].shape[2], None),
            ("E_out", "out_src", meta.LPI, None),
            ("E_end", "end_src", meta.OL, I)):
        E = np.asarray(tb[name])
        if stride_view is None:
            xg = rng.standard_normal((rows, G)).astype(np.float32)
            flat = xg.reshape(-1, 1)
        else:                                      # the (OL, I)[:, :G] view
            flat = rng.standard_normal((rows * I, 1)).astype(np.float32)
            xg = flat.reshape(rows, I)[:, :G]
        want = typed_mm(E, xg).reshape(-1)
        np.testing.assert_array_equal(gather(flat, ix[src])[:, 0], want,
                                      err_msg=name)
    E_app = np.asarray(tb["E_app"])
    xg = rng.standard_normal((meta.LPI, G)).astype(np.float32)
    for kin in range(E_app.shape[1]):
        want = typed_mm(E_app[:, kin], xg).reshape(-1)
        np.testing.assert_array_equal(
            gather(xg.reshape(-1, 1), ix["app_src_g"][kin])[:, 0], want)
    if "foe_perm" in tb:
        S2 = meta.KC * meta.LPI
        xg = rng.standard_normal((S2, G)).astype(np.float32)
        want = typed_mm(np.asarray(tb["foe_perm"]), xg).reshape(-1)
        np.testing.assert_array_equal(
            gather(xg.reshape(-1, 1), ix["foe_src"])[:, 0], want)
    assert T >= 1


@pytest.mark.parametrize("config", ["config_4x4.json", "config_2x2.json"])
def test_index_tables_gather_like_einsums(config):
    tb, meta = build_ring(compile_scenario(_fix(config)), 1.0)
    _assert_index_tables_gather_like_einsums(tb, meta)


def test_index_tables_refuse_a_row_with_two_ones():
    tb, meta = build_ring(compile_scenario(_fix("config_2x2.json")), 1.0)
    bad = dict(tb)
    E = np.array(tb["E_start"])
    row = np.nonzero(E[0].sum(1))[0][0]
    E[0, row, :2] = 1.0
    bad["E_start"] = E
    with pytest.raises(ValueError, match="not a gather"):
        index_tables(bad, meta.type_ranges, meta.G, meta.I)


def test_foe_gather_branch_selects_like_foe_perm():
    """A net too big for the dense foe permutation carries `foe_gather`
    (flat foe index, 0 on invalid crosses) instead; index_tables takes it
    as is, and on every valid cross it selects what foe_perm selects."""
    tb, meta = build_ring(compile_scenario(_fix("config_4x4.json")), 1.0)
    ix = index_tables(tb, meta.type_ranges, meta.G, meta.I)
    perm_src = ix["foe_src"]
    alt = {k: v for k, v in tb.items() if k != "foe_perm"}
    alt["foe_gather"] = np.where(perm_src >= 0, perm_src, 0) \
        .reshape(meta.KC, meta.LKp).astype(np.int32)
    got = index_tables(alt, meta.type_ranges, meta.G, meta.I)["foe_src"]
    valid = np.asarray(tb["lk_cvalid"]).reshape(-1)
    assert np.array_equal(got[valid], perm_src[valid])
    assert (perm_src[~valid] == -1).all()


@pytest.mark.parametrize("generated", [False, True])
def test_prepare_stages_the_scenario_under_build(tmp_path, generated):
    """scenario.prepare copies a config's files (or regenerates a benchmark
    grid) into build/scenarios/ and writes nothing into the config's dir,
    which may name a directory that does not exist."""
    from cityflow_tpu_torch.tools.scenario import ROOT as PKG_ROOT, prepare
    with open(_fix("config_4x4.json")) as f:
        cfgj = json.load(f)
    missing = tmp_path / "absent"
    if generated:
        shutil.copy(os.path.join(ROOT, "benchmarks", "flow_16_16.json"),
                    tmp_path / "flow.json")
        cfgj.update(roadnetFile="roadnet_16_16.json", flowFile="flow.json")
    else:
        for k in ("roadnetFile", "flowFile"):
            shutil.copy(_fix(cfgj[k]), tmp_path / cfgj[k])
    cfgj["dir"] = str(missing) + "/"
    cfg = tmp_path / f"config_prepare_{int(generated)}.json"
    cfg.write_text(json.dumps(cfgj))
    path = prepare(str(cfg))
    staged = os.path.dirname(path)
    assert staged == os.path.join(PKG_ROOT, "build", "scenarios", cfg.stem)
    with open(path) as f:
        assert json.load(f)["dir"] == staged + "/"
    assert not missing.exists()
    if generated:
        gridgen.main(["16", "16", "--dir", str(tmp_path) + "/",
                      "--roadnetFile", "want.json", "--flowFile", "f.json"])
        want = tmp_path / "want.json"
    else:
        want = tmp_path / cfgj["roadnetFile"]
    with open(os.path.join(staged, cfgj["roadnetFile"]), "rb") as f:
        assert f.read() == want.read_bytes()
    with open(os.path.join(staged, cfgj["flowFile"]), "rb") as f:
        assert f.read() == (tmp_path / cfgj["flowFile"]).read_bytes()
    assert compile_scenario(path) is not None
