#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  build     the card's name and power limit (nvidia-smi), then the build
            of the four kernels from csrc/ (nvcc, sm_90a) with its time
  scenario  the 30x30 grid regenerated by the port's gridgen into build/,
            compiled by the port's compiler
  kernels   K1-K4 against their plain PyTorch versions on the card, at
            the main path's 30x30 call-site shapes (B=128) with seeded
            numpy inputs; times, bounds and the library yardstick
  agree     B=1 on the card (kernels) against the plain port on the CPU,
            20 steps: same vehicles on the same drivables, |dis| and
            |speed| within 2e-3, same finished count
  main      the main path (tools/bench.run_ring: p1 + p2 batched) at
            B=128, halved on out-of-memory; asserts overflow == 0,
            vehicles > 0, every env equal to env 0 bitwise, and every
            kernel launched; prints ms per batched step, env-steps/s, the
            p1/p2 split, each kernel's share and peak memory

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12              # float32 outside the tensor cores
BATCH = 128                         # envs on the main path and the kernels
STEPS = 40                          # timed main-path steps
WARMUP = 8                          # main-path steps before the timing
AGREE_STEPS = 20                    # card-vs-CPU agreement steps at B=1
REPS = 10                           # launches per kernel timing
REPLACES = {
    "gather_rows": "cityflow_tpu/core/ring.py:243 (_typed_mm), :300-341 "
                   "(exchanges), :881-927 (foe_perm)",
    "cross_caps": "cityflow_tpu/core/ring.py:936 (cross_caps)",
    "car_follow": "cityflow_tpu/core/ring.py:998 (isr_speed), :1042 "
                  "(min_chain)",
    "ring_commit": "cityflow_tpu/core/ring.py:1691 (shift_out/append_k), "
                   ":1838 (commit_l)",
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


def time_cuda(fn, reps):
    """Mean device time of fn() in ms over `reps` launches (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel checks at the 30x30 call-site shapes
# ---------------------------------------------------------------------------

def check_kernels(sim, B, reps):
    import numpy as np
    import torch
    from cityflow_tpu_torch.kernels import (
        car_follow, cross_caps, gather_rows, ring_commit)
    from cityflow_tpu_torch.core.ring import _Ctx

    cfg, net = sim.cfg, sim.tables
    dev = sim.device
    rng = np.random.default_rng(0)
    T = lambda a: torch.as_tensor(a, device=dev).contiguous()
    cx = _Ctx(net, cfg, dev)
    rows = []
    LKp, LNp, KC, SK, SL = cfg.LKp, cfg.LNp, cfg.KC, cfg.SK, cfg.SL
    IL, G, LPI, AP = cfg.IL, cfg.G, cfg.LPI, cfg.AP

    def row(name, err, ms, plain_ms, nbytes, nops, lib_ms):
        bound = max(nbytes / H100_BYTES_PER_S, nops / H100_F32_FLOPS) * 1e3
        rows.append(dict(
            name=name, route="cuda",
            source=f"cityflow_tpu_torch/csrc/{name}.cu",
            replaces=REPLACES[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S
            >= nops / H100_F32_FLOPS else "operations",
            library_ms=lib_ms))
        log(f"[kernels] {name}: max_abs_err={err} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} "
            f"library_ms={lib_ms}")

    # ---- K1: the forward exchange (lane -> in-lane, 44 channels) and the
    #      foe exchange (9 channels), static; to_link, dynamic
    C = 14 * AP + 2
    x = T(rng.standard_normal((C, LNp, B)).astype(np.float32))
    idx = net["in_src"].reshape(-1)
    got = gather_rows.gather_rows(x, idx, 0.0)
    want = gather_rows.gather_rows_plain(x, idx, 0.0)
    err = float((got - want).abs().max())
    assert torch.equal(got, want), "gather_rows (static) mismatch"
    xf = T(rng.standard_normal((9, KC * LKp, B)).astype(np.float32))
    fidx = net["foe_src"]
    assert torch.equal(gather_rows.gather_rows(xf, fidx, 0.0),
                       gather_rows.gather_rows_plain(xf, fidx, 0.0)), \
        "gather_rows (foe) mismatch"
    nxt = T(rng.integers(-1, LKp, (IL, G, B)).astype(np.int32) + cfg.LNp)
    didx = cx.to_link_idx(cx.lpi_of(nxt))
    x5 = T(rng.standard_normal((5, IL * G, B)).astype(np.float32))
    assert torch.equal(gather_rows.gather_rows(x5, didx=didx, fill=0.0),
                       gather_rows.gather_rows_plain(x5, didx=didx,
                                                     fill=0.0)), \
        "gather_rows (dynamic) mismatch"
    ms = time_cuda(lambda: gather_rows.gather_rows(xf, fidx, 0.0), reps)
    plain = time_cuda(lambda: gather_rows.gather_rows_plain(xf, fidx, 0.0),
                      reps)
    fl = fidx.clamp(min=0).long()
    lib = time_cuda(lambda: xf.index_select(1, fl), reps)
    nsrc = int(torch.unique(fidx[fidx >= 0]).numel())
    nbytes = 4 * (9 * nsrc * B + 9 * fidx.numel() * B + fidx.numel())
    row("gather_rows", err, ms, plain, nbytes, 0, lib)

    # ---- K2: link rows, R = SKC
    R = min(cfg.SKC, SK)
    f32 = lambda *s, lo=0.0, hi=1.0: T(rng.uniform(lo, hi, s)
                                        .astype(np.float32))
    dls = f32(R, LKp, B, lo=-20.0, hi=80.0)
    speed = f32(R, LKp, B, lo=0.0, hi=17.0)
    ent = T(rng.integers(0, 300, (R, LKp, B)).astype(np.float32))
    ph = T(rng.integers(-3, 3, (R, LKp, B)).astype(np.float32))
    plo = T(rng.integers(0, 4, (R, LKp, B)).astype(np.float32))
    rel = T(rng.random((R, LKp, B)) < 0.7)
    foe = torch.stack([
        T((rng.random((KC, LKp, B)) < 0.5).astype(np.float32))
        for _ in range(4)] + [
        T(rng.integers(0, 256, (KC, LKp, B)).astype(np.float32)),
        f32(KC, LKp, B, lo=-10.0, hi=60.0),
        T(rng.integers(0, 300, (KC, LKp, B)).astype(np.float32)),
        T(rng.integers(-3, 3, (KC, LKp, B)).astype(np.float32)),
        T(rng.integers(0, 4, (KC, LKp, B)).astype(np.float32))])
    args = (dls, speed, ent, ph, plo, rel, foe, cx.cc_tabs, cx.prm_cc)
    got = cross_caps.cross_caps(*args)
    want = cross_caps.cross_caps_plain(*args)
    for g_, w_, n_ in zip(got, want, ("any_fail", "ff_d", "ff_foe")):
        bad = int((g_ != w_).sum())
        log(f"[kernels] cross_caps {n_}: mismatches={bad}")
        assert bad == 0, f"cross_caps {n_} mismatch"
    err = float((got[1] - want[1]).nan_to_num(0.0, 0.0, 0.0).abs().max())
    ms = time_cuda(lambda: cross_caps.cross_caps(*args), reps)
    plain = time_cuda(lambda: cross_caps.cross_caps_plain(*args), reps)
    # a row reads the foe channels, t2 and foelpi only of the crosses it
    # considers (valid, ahead of it, row relevant); count those of this data
    tb = cx.cc_tabs
    need = torch.zeros((KC, LKp, B), dtype=torch.bool, device=dev)
    n_cons = 0
    for r in range(R):
        c_r = tb["cvalid"][..., None] & (tb["d"][..., None] >= dls[r]) \
            & rel[r]
        n_cons += int(c_r.sum())
        need |= c_r
    n = R * LKp * B
    nbytes = (n * (5 * 4 + 1)                      # dls speed ent ph plo rel
              + KC * LKp * (4 + 1)                 # d, cvalid
              + int(need.any(-1).sum()) * (4 + 4)  # t2, foelpi
              + LKp * (4 + 1)                      # t1, turn
              + int(need.sum()) * 9 * 4            # foe channels
              + n * (1 + 4 + 4))                   # any_fail, ff_d, ff_foe
    row("cross_caps", err, ms, plain, nbytes, n_cons * 60, None)

    # ---- K3: link rows, mode 3 (isr + min_chain)
    shp = (SK, LPI, G, B)
    kin = dict(
        speed=f32(*shp, hi=17.0), dls=f32(*shp, hi=80.0),
        isr_lane_left=0.0, any_fail=T(rng.random(shp) < 0.3),
        ff_d=f32(*shp, hi=90.0), app=False,
        avail=T(rng.random((LPI, G, B)) < 0.5),
        can_enter=T(rng.random((LPI, G, B)) < 0.5),
        turn=net["lk_turn"].reshape(LPI, G, 1), gap=f32(*shp, lo=-5.0,
                                                        hi=100.0),
        lead_spd=f32(*shp, hi=17.0), has_lead=T(rng.random(shp) < 0.8),
        isr_rel=True, custom=f32(*shp, hi=17.0),
        has_custom=T(rng.random(shp) < 0.1), drv_maxspd=10000.0,
        invalid=False, lane_left=0.0)
    got = car_follow.car_follow(3, cx.prm_cf, shp, **kin)
    want = car_follow.car_follow_plain(3, cx.prm_cf, shp, **kin)
    err = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
    nbit = sum(int((g_ != w_).sum()) for g_, w_ in zip(got, want))
    log(f"[kernels] car_follow: max_abs_err={err} not_bitwise={nbit}")
    assert err <= 1e-5, "car_follow mismatch"
    # lane rows, mode 2
    lshp = (SL, LNp, B)
    lin = dict(speed=f32(*lshp, hi=17.0), gap=f32(*lshp, lo=-5.0, hi=100.0),
               lead_spd=f32(*lshp, hi=17.0),
               has_lead=T(rng.random(lshp) < 0.8), v_isr=0.0, isr_rel=False,
               custom=f32(*lshp, hi=17.0),
               has_custom=T(rng.random(lshp) < 0.1),
               drv_maxspd=net["ln_maxspd"][:, None],
               invalid=T(rng.random(lshp) < 0.05),
               lane_left=f32(*lshp, lo=-2.0, hi=300.0))
    got = car_follow.car_follow(2, cx.prm_cf, lshp, **lin)
    want = car_follow.car_follow_plain(2, cx.prm_cf, lshp, **lin)
    err2 = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
    assert err2 <= 1e-5, "car_follow (lane rows) mismatch"
    got = car_follow.car_follow(2, cx.prm_cf, lshp, raw=True, **lin)
    want = car_follow.car_follow_plain(2, cx.prm_cf, lshp, raw=True, **lin)
    err2 = max(err2, float((got - want).abs().max()))
    assert err2 <= 1e-5, "car_follow (raw) mismatch"
    # approach rows, mode 1 (isr only)
    ashp = (AP, LPI, G, B)
    ain = dict(speed=f32(*ashp, hi=17.0), dls=f32(*ashp, lo=-30.0, hi=5.0),
               isr_lane_left=f32(*ashp, lo=-5.0, hi=80.0),
               any_fail=T(rng.random(ashp) < 0.3), ff_d=f32(*ashp, hi=90.0),
               app=True, avail=T(rng.random((LPI, G, B)) < 0.5),
               can_enter=T(rng.random((LPI, G, B)) < 0.5),
               turn=net["lk_turn"].reshape(LPI, G, 1))
    got = car_follow.car_follow(1, cx.prm_cf, ashp, **ain)
    want = car_follow.car_follow_plain(1, cx.prm_cf, ashp, **ain)
    assert torch.equal(got[1], want[1]), "car_follow (isr) red_stop mismatch"
    err2 = max(err2, float((got[0] - want[0]).abs().max()))
    assert err2 <= 1e-5, "car_follow (isr) mismatch"
    err = max(err, err2)
    ms = time_cuda(lambda: car_follow.car_follow(2, cx.prm_cf, lshp, **lin),
                   reps)
    plain = time_cuda(
        lambda: car_follow.car_follow_plain(2, cx.prm_cf, lshp, **lin), reps)
    n = SL * LNp * B
    # speed gap lead_spd custom lane_left (f32), has_lead has_custom invalid
    # (bool) in, new_speed and delta out, drv_maxspd per lane
    row("car_follow", err, ms, plain, n * (5 * 4 + 3 * 1 + 2 * 4) + LNp * 4,
        n * 80, None)

    # ---- K4: lane ring, 12 channels, A = KIN * XK candidates sorted
    XK = cfg.XK
    A = cfg.KIN * min(XK, SK)
    n_l = T(rng.integers(0, SL + 1, (LNp, B)).astype(np.int32))
    x_l = torch.minimum(n_l, T(rng.integers(0, XK + 1, (LNp, B))
                               .astype(np.int32)))
    app = torch.stack([f32(14, cfg.OL * G, B, lo=0.0, hi=30.0)
                       for _ in range(A)])
    app[:, 13] = T((rng.random((A, cfg.OL * G, B)) < 0.3).astype(np.float32))
    app[:, 2:5] = app[:, 2:5].floor()
    app[:, 6:13] = app[:, 6:13].floor()
    iring = lambda lo, hi: T(rng.integers(lo, hi, (SL, LNp, B))
                             .astype(np.int32))
    chans = [(f32(SL, LNp, B, hi=300.0), "f32", 0.0, 0, 0),
             (f32(SL, LNp, B, hi=17.0), "f32", 0.0, 1, 0),
             (iring(0, 100), "i32", 0.0, 2, 0),
             (iring(0, 100), "i32", 0.0, 3, 0),
             (iring(0, 10), "i32", 0.0, 4, 0),
             (f32(SL, LNp, B, hi=300.0), "f32", 0.0, 5, 0),
             (iring(-2**31, 2**31 - 1), "pri", 0.0, 6, 7),
             (iring(-1, 10**6), "i32", -1.0, 8, 0),
             (iring(-1, 50000), "i32", -1.0, 9, 0),
             (iring(-1, 50000), "i32", -1.0, 10, 0),
             (T(rng.random((SL, LNp, B)) < 0.2), "bool", 0.0, 11, 0),
             (iring(-1, 50000), "i32", -1.0, 12, 0)]
    kw = dict(valid_ch=13, sort_ch=0, nsel=min(cfg.SA, A), XK=XK,
              app_I=cfg.I, app_G=G)
    got = ring_commit.ring_commit(chans, x_l, n_l - x_l, app, **kw)
    want = ring_commit.ring_commit_plain(chans, x_l, n_l - x_l, app, **kw)
    bad = sum(int((g_ != w_).sum()) for g_, w_ in zip(got, want))
    log(f"[kernels] ring_commit (lane): mismatches={bad}")
    assert bad == 0, "ring_commit mismatch"
    ms = time_cuda(lambda: ring_commit.ring_commit(
        chans, x_l, n_l - x_l, app, **kw), reps)
    plain = time_cuda(lambda: ring_commit.ring_commit_plain(
        chans, x_l, n_l - x_l, app, **kw), reps)
    # link ring: entrants in order, the entry step as a per-env value
    n_k = T(rng.integers(0, SK + 1, (LKp, B)).astype(np.int32))
    x_k = torch.minimum(n_k, T(rng.integers(0, XK + 1, (LKp, B))
                               .astype(np.int32)))
    ent = f32(AP, 11, LKp, B, hi=30.0).floor()
    ent[:, 0] = T((rng.random((AP, LKp, B)) < 0.3).astype(np.float32))
    kring = lambda lo, hi: T(rng.integers(lo, hi, (SK, LKp, B))
                             .astype(np.int32))
    kch = [(f32(SK, LKp, B, hi=60.0), "f32", 0.0, 1, 0),
           (kring(0, 100), "i32", 0.0, 3, 0),
           (kring(-2**31, 2**31 - 1), "pri", 0.0, 7, 8),
           (kring(-1, 10**6), "i32", -1.0, 9, 0),
           (kring(0, 2**31 - 1), "i32", float(2**31 - 1), -1, 0)]
    kkw = dict(valid_ch=0, sort_ch=-1, nsel=AP, XK=XK,
               envval=T(np.full(B, 7.0, np.float32)))
    got = ring_commit.ring_commit(kch, x_k, n_k - x_k, ent, **kkw)
    want = ring_commit.ring_commit_plain(kch, x_k, n_k - x_k, ent, **kkw)
    bad = sum(int((g_ != w_).sum()) for g_, w_ in zip(got, want))
    log(f"[kernels] ring_commit (link): mismatches={bad}")
    assert bad == 0, "ring_commit (link) mismatch"
    # per channel a column reads its SL - x surviving slots and writes all
    # SL; of the candidates it reads every valid flag, the sort key of the
    # valid ones and the entrant channels of the ones it takes
    esz = sum(c[0].element_size() for c in chans)
    keep = int((SL - x_l).sum())
    nvalid = (app[:, 13] > 0.5).sum(0)
    taken = int(nvalid.clamp(max=kw["nsel"]).sum())
    n_app_ch = sum((c[3] >= 0) + (c[1] == "pri") for c in chans)
    nbytes = (esz * (keep + SL * LNp * B) + 2 * LNp * B * 4
              + 4 * (A * cfg.OL * G * B + int(nvalid.sum())
                     + n_app_ch * taken))
    row("ring_commit", 0.0, ms, plain, nbytes, 0, None)
    return rows


# ---------------------------------------------------------------------------
# agreement: card (kernels) vs CPU (plain), B = 1
# ---------------------------------------------------------------------------

def vehicles(st):
    out = {}
    for pre in ("l", "k"):
        n = getattr(st, f"n_{pre}").cpu().numpy()
        uid = getattr(st, f"{pre}_uid").cpu().numpy()
        dis = getattr(st, f"{pre}_dis").cpu().numpy()
        spd = getattr(st, f"{pre}_speed").cpu().numpy()
        for p in n.nonzero()[0]:
            for s in range(int(n[p])):
                out[int(uid[s, p])] = ((pre, int(p)), float(dis[s, p]),
                                       float(spd[s, p]))
    return out


def check_agreement(net, steps):
    from cityflow_tpu_torch import ring_sim
    gpu = ring_sim.build_sim(net, horizon=steps + 8, sl=40)
    cpu = ring_sim.build_sim(net, horizon=steps + 8, sl=40, device="cpu")
    worst = 0.0
    for i in range(1, steps + 1):
        ring_sim.step(gpu)
        ring_sim.step(cpu)
        if i % 5 and i != steps:
            continue
        a, b = vehicles(cpu.state), vehicles(gpu.state)
        assert set(a) == set(b), f"step {i}: vehicle sets differ"
        for u in a:
            assert a[u][0] == b[u][0], f"step {i}: uid {u} drivable"
            worst = max(worst, abs(a[u][1] - b[u][1]),
                        abs(a[u][2] - b[u][2]))
        assert worst <= 2e-3, f"step {i}: worst drift {worst}"
    assert int(cpu.state.finished_cnt) == int(gpu.state.finished_cnt)
    assert int(gpu.state.overflow) == 0
    log(f"[agree] {steps} steps B=1: vehicles={len(a)} worst_drift={worst}")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def kernel_shares(sim, state, nsteps):
    """Device time per kernel wrapper (CUDA events around each launch)
    and per phase over `nsteps` batched steps."""
    import torch
    from cityflow_tpu_torch.core import ring as ring_mod
    names = ("gather_rows", "cross_caps", "car_follow", "ring_commit")
    orig = {n: getattr(ring_mod, n) for n in names}
    events = {n: [] for n in names}

    def timed(n):
        def fn(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = orig[n](*a, **k)
            e.record()
            events[n].append((s, e))
            return out
        return fn

    phase_ms = {"p1": 0.0, "p2": 0.0}
    try:
        for n in names:
            setattr(ring_mod, n, timed(n))
        for _ in range(nsteps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            state, mid = ring_mod.ring_step_p1_batched(sim.tables, sim.cfg,
                                                       state, sim.q)
            ev[1].record()
            state = ring_mod.ring_step_p2_batched(sim.tables, sim.cfg, state,
                                                  mid)
            ev[2].record()
            torch.cuda.synchronize()
            phase_ms["p1"] += ev[0].elapsed_time(ev[1]) / nsteps
            phase_ms["p2"] += ev[1].elapsed_time(ev[2]) / nsteps
    finally:
        for n in names:
            setattr(ring_mod, n, orig[n])
    torch.cuda.synchronize()
    per = {n: sum(s.elapsed_time(e) for s, e in events[n]) / nsteps
           for n in names}
    return per, phase_ms


def main_path(cfg_path, batch, warmup, steps):
    import torch
    from cityflow_tpu_torch import kernels
    from cityflow_tpu_torch.compiler.net import compile_scenario
    from cityflow_tpu_torch.tools import bench

    net = compile_scenario(cfg_path)
    args = bench.parser().parse_args(
        ["--config", cfg_path, "--batch", str(batch), "--warmup",
         str(warmup), "--window", "0", "--steps", str(steps)])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    r, B = bench.run_ring_ladder(args, net, batch)
    launches = kernels.launch_counts()
    st = r["state"]
    ms = r["seconds"] * 1e3 / r["steps"]
    log(f"[main] B={B} steps={r['steps']} ms_per_batched_step={ms:.3f} "
        f"env_steps_per_s={B * r['steps'] / r['seconds']:.1f} "
        f"vehicles_per_env={r['vehicles']} overflow={r['overflow']} "
        f"first_step_s={r['first_step_s']:.2f}")
    log(f"[main] launches={launches}")
    assert r["overflow"] == 0, "overflow flags set"
    assert r["vehicles"] > 0, "no vehicles"
    for k, v in st.leaves().items():
        assert torch.equal(v, v[..., :1].expand_as(v)), \
            f"env columns differ in {k}"
    for k, v in launches.items():
        assert v > 0, f"kernel {k} was not launched on the main path"
    peak = torch.cuda.max_memory_allocated()
    per, phase = kernel_shares(r["sim"], st, 3)
    tot = phase["p1"] + phase["p2"]
    log(f"[main] p1_ms={phase['p1']:.3f} p2_ms={phase['p2']:.3f} "
        f"(CUDA events, 3 steps)")
    for n, v in per.items():
        log(f"[main] kernel {n}: {v:.3f} ms/step ({100 * v / tot:.1f}% of "
            f"the step)")
    log(f"[main] max_memory_allocated={peak} bytes ({peak / 2**30:.2f} GiB)")
    return launches, dict(B=B, ms_per_step=ms, p1_ms=phase["p1"],
                          p2_ms=phase["p2"], kernel_ms=per,
                          env_steps_per_s=B * r["steps"] / r["seconds"],
                          peak_bytes=peak, vehicles=r["vehicles"])


def main():
    if not os.path.isdir(os.path.join(HERE, "cityflow_tpu_torch")):
        print("chip_smoke: the cityflow_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(smi)
    from cityflow_tpu_torch.kernels import _lib
    t0 = time.time()
    L = _lib.lib()
    log(f"[build] kernels built in {time.time() - t0:.1f} s "
        f"(nvcc {_lib.build_seconds})")
    ptxas = L._name + ".ptxas.txt"
    if os.path.exists(ptxas):
        with open(ptxas) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"[build] {line.strip()}")

    t0 = time.time()
    from cityflow_tpu_torch.tools.scenario import prepare
    cfg_path = prepare(os.path.join(HERE, "benchmarks", "config_30x30.json"))
    from cityflow_tpu_torch import ring_sim
    from cityflow_tpu_torch.compiler.net import compile_scenario
    net = compile_scenario(cfg_path)
    sim = ring_sim.build_sim(net, horizon=16, sl=40)
    c = sim.cfg
    log(f"[scenario] 30x30 in {time.time() - t0:.1f} s: I={c.I} G={c.G} "
        f"LPI={c.LPI} KC={c.KC} IL={c.IL} OL={c.OL} LNp={c.LNp} "
        f"LKp={c.LKp} SL={c.SL} SK={c.SK} AP={c.AP} XK={c.XK}")

    rows = check_kernels(sim, BATCH, REPS)
    del sim
    torch.cuda.empty_cache()
    check_agreement(net, AGREE_STEPS)
    launches, res = main_path(cfg_path, BATCH, WARMUP, STEPS)
    for r in rows:
        r["launches"] = launches[r["name"]]
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    log(f"[main] {json.dumps(res)}")
    print(json.dumps({"kernels": [{k: r[k] for k in order} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
