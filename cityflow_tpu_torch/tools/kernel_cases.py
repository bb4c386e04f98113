"""Seeded edge cases of K4 ring_commit, T1 tpl_params, K3 car_follow, K2
cross_caps, L2 lc_receive, G12 admit_heads, L3 lc_insert, L1 lc_signal,
G4 cross_pass, G15 shadow_insert, L4 lc_partner, G3 notify_cross, G11
spawn_slots, G5 hist_window, O2 phase_pressure and R2 ring_exits (its
exits stage).

The same cases feed the CPU tests (tests/test_torch_commit_cases.py,
tests/test_torch_follow_cases.py, tests/test_torch_receive_cases.py and
tests/test_torch_admit_cases.py: the plain versions against numpy walks)
and chip_smoke.py (the kernels against the plain versions on the card, bit
for bit), so what the kernels are held to on the card is what the tests
show right on the CPU.

    for name, case in commit_cases():
        args, kw = commit_args(case, device)     # ring_commit(*args, **kw)
    for name, case in tpl_cases():
        tpl, table, cols = tpl_args(case, device)
    for name, case in follow_cases():
        args, kw = follow_args(case, device)     # car_follow(*args, **kw)
    for name, case in caps_cases():
        args, kw = caps_args(case, device)       # cross_caps(*args, **kw)
    for name, case in receive_cases():
        args, kw = receive_args(case, device)    # lc_receive(*args, **kw)
    for name, case in admit_cases():
        args = admit_args(case, device)          # admit_heads(*args)
    for name, case in cross_cases():
        args = cross_args(case, device)          # cross_pass(*args)
    for name, case in shadow_cases():
        args = shadow_args(case, device)         # shadow_insert(*args),
                                                 # fresh tensors each call
    for name, case in spawn_cases():             # spawn_slots(*args,
        args = spawn_args(case, device)          # inplace=...), fresh
    for name, case in hist_cases():              # hist_window(*args,
        args = hist_args(case, device)           # inplace=...), fresh
    for name, case in pressure_cases():
        args = pressure_args(case, device)       # phase_pressure(*args,
                                                 # features=...)
    for name, case in exits_cases():
        args = exits_args(case, device)          # ring_exits(*args),
                                                 # fresh tensors each call

Each case is a dict of numpy arrays and ints, made from its own seed
(commit_case(name), tpl_case(name): one case without the others).

K4 (lane, link and lane-change commits at B = 1, 3, 128 and 130, S = 128,
MAX_CH channels of every kind, A = MAX_A candidates): equal sort keys,
columns whose candidates are all invalid, columns past app_G (no
entrants), x = n (every vehicle leaves), x above XK (the JAX shift treats
it as 0), entrants that run past the last slot, delete masks that exceed
the XD cap or delete the last slot, saturating fills and entrant values
(NaN, +-1e10, 2^31). Then longer rings, which the kernel takes in chunks
of rows: S = 300 and 900 in each mode, and a shift (XK) or a delete cap
(XD) longer than the halo a chunk's tile carries.

T1 (TP = 1, 3 and 1024): n % 4 != 0, a view that starts one element in (not
16-byte aligned), indices -1, TP and far outside, repeated and reordered
columns.

K3 (FOLLOW_CASES): modes 1, 2 and 3; raw; the lane-change mode (v_yield);
the template mode (TP = 3, and 100, more than the kernel derives into
shared memory); the ring-leader mode on lane and link rows; at B = 1, 3,
128 and 130, with the views the ring paths pass (scalars, (LPI, G, 1),
(LPI, G, B), (N, 1), (IL, G, B) against (AP, IL, G, B), full) and views
that start one element in. Rows with n = 0 and n = S, link rows whose
slot 0 has an end-lane tail and ones without, lane fronts whose in-lane
is -1 or whose approach row is not relevant, template indices -1, TP and
far outside, stopped vehicles with no distance left (the 0 / 0 that the
reference's std::min keeps), NaN and +-inf inputs.

K2 (CAPS_CASES): R = 1 to 4 rows, KC = 1, 5 and 20 crosses (two chunks of
the kernel's 16), B = 1, 3, 33, 128 and 130 (not a multiple of the
kernel's 32-env tile), rows that are not relevant, crosses whose foe_src
is -1, equal cross distances (the largest foe lpi wins), priorities equal
in the high half, reach steps at and above 255, the template mode and the
approach rows' single enter time.

L2 (RECEIVE_CASES) and G12 (ADMIT_CASES): the edges each generator's
docstring names, at B = 1, 3, 128 and 130; L2 at S = 1, 40 and rings
longer than its kernel's table of 48 receivers, G12 in f64 and f32.

G4 (CROSS_CASES) and G15 (SHADOW_CASES): the edges their generators'
docstrings name, at B = 1, 3, 128 and 130 in f32 and f64; G4 at KC = 1
to 20, G15 at MS = 1 to 200 with
pools of several scan chunks and misaligned views.

G11 (SPAWN_CASES, both forms; SPAWN_COPY_CASES are those the copying
form takes) and G5 (HIST_CASES, both forms): the edges their
generators' docstrings name, at B = 1 to 130 in f32 and f64; G11 at
MS = 1 to 64 on pools of 16 to 9000 slots, G5 at rings of 4 to 241
rows, each env at its own hist_t.

O2 (PRESSURE_CASES, both modes) and R2's exits stage (EXITS_CASES, in
place): the edges their generators' docstrings name; O2 at P = 1 to
MAX_P = 64, B = 1 to 130 and up to 300 links an intersection, R2 at
B = 1 to 130, SL = 1 to 40, XK = 1 to 4, with and without lane change
and the lights, and a view one element in.
"""

import numpy as np

MAX_CH = 32
MAX_A = 16
KINDS = ("f32", "i32", "bool", "pri")
COMMIT_BATCHES = (1, 3, 128, 130)


def _commit_case(rng, mode, B, N=8, S=128, nch=MAX_CH, A=MAX_A, XK=3,
                 XD=5, pdel=0.15):
    """One seeded case of `mode` ("lane", "link" or "lc"); pdel: the share
    of slots the lane-change mode deletes."""
    sort = mode != "link"
    # lane and lc modes: N = OL * app_I lane columns, app_G < app_I, so
    # every fourth column has no entrant column
    app_I, app_G = (4, 3) if sort else (0, 0)
    AC = (N // app_I) * app_G if app_I else N
    PCH = 2 * nch + 2                 # valid, key, then two per channel
    valid_ch, sort_ch = 0, 1 if sort else -1
    app = rng.uniform(-5.0, 40.0, (A, PCH, AC, B)).astype(np.float32)
    # the valid flag: some near 0.5 on either side
    app[:, valid_ch] = rng.choice(np.float32([0.0, 1.0, 0.3, 0.7, 0.5]),
                                  (A, AC, B), p=[0.35, 0.35, 0.1, 0.1, 0.1])
    # every pair of entrant column 0 has no valid candidate
    app[:, valid_ch, 0] = 0.0
    # sort keys from a small set: equal keys among valid candidates
    app[:, 1] = rng.choice(np.float32([0.0, 2.5, 7.0, 7.0, 11.25, 30.0]),
                           (A, AC, B))
    # entrant values: integral for the int kinds, some far out of range
    ints = rng.integers(-3000, 3000, (A, PCH - 2, AC, B)).astype(np.float32)
    wild = rng.choice(np.float32([np.nan, 1e10, -1e10, 2.0 ** 31,
                                  -(2.0 ** 31), 65535.0]), ints.shape)
    ints = np.where(rng.random(ints.shape) < 0.05, wild, ints)
    chans, fills = [], (0.0, -1.0, float(2 ** 31 - 1), 1.0, 2.5, -7.0)
    for c in range(nch):
        kind = KINDS[c % 4]
        hi, lo = 2 + 2 * c, 3 + 2 * c
        if kind == "f32":
            upd = rng.standard_normal((S, N, B)).astype(np.float32) * 50
        elif kind == "bool":
            upd = rng.random((S, N, B)) < 0.4
            app[:, hi] = rng.random((A, AC, B)).astype(np.float32)
        else:
            upd = rng.integers(-2 ** 31, 2 ** 31 - 1, (S, N, B),
                               dtype=np.int64).astype(np.int32)
            app[:, hi] = ints[:, hi - 2]
            app[:, lo] = ints[:, lo - 2]
        # a few channels take the per-env value
        app_ch = -1 if c % 7 == 5 else hi
        chans.append((upd, kind, fills[c % len(fills)], app_ch, lo))
    n_occ = rng.integers(0, S + 1, (N, B)).astype(np.int32)
    n_occ[:, 0] = S                           # full columns: entrants drop
    x = np.minimum(n_occ, rng.integers(0, XK + 1, (N, B))).astype(np.int32)
    x[1] = n_occ[1]                           # x = n: every vehicle leaves
    x[2, ::2] = XK + 2                        # above XK: shifts by 0
    base = (n_occ - np.minimum(x, n_occ)).astype(np.int32)
    base[3] = S - 2                           # entrants run past the end
    # the lane mode takes fewer than A (the SA cap drops valid ones)
    nsel = {"lane": A - 4, "link": 5, "lc": A}[mode]
    case = dict(chans=chans, x=x, base=base, app=app, valid_ch=valid_ch,
                sort_ch=sort_ch, nsel=nsel, XK=XK, app_I=app_I, app_G=app_G,
                envval=rng.uniform(0, 500, B).astype(np.float32))
    if mode == "lc":
        dmask = rng.random((S, N, B)) < pdel
        dmask[:, 1] = rng.random((S, B)) < 0.6    # far above the XD cap
        dmask[:, 2] = False                       # nothing deleted
        dmask[:, 4] = False                       # the last slot and one
        dmask[S - 1, 4] = True                    # above it in half the
        dmask[S // 2, 4, ::2] = True              # envs
        case.update(x=None, dmask=dmask, XD=XD)
    return case


MODES = ("lane", "link", "lc")
# name -> (mode, B, keywords of _commit_case)
COMMIT_SPECS = {f"{m}_B{B}": (m, B, {}) for m in MODES
                for B in COMMIT_BATCHES}
COMMIT_SPECS.update({
    "lane_S300_B32": ("lane", 32, dict(S=300, nch=12)),
    "link_S900_B32": ("link", 32, dict(S=900, nch=8)),
    "link_S300_B32_XK200": ("link", 32, dict(S=300, nch=8, XK=200)),
    "lc_S300_B32": ("lc", 32, dict(S=300, nch=12, pdel=0.01)),
    "lc_S900_B32_XD200": ("lc", 32, dict(S=900, nch=8, XD=200, pdel=0.1)),
})
COMMIT_CASES = tuple(COMMIT_SPECS)


def commit_case(name, seed=0):
    """The case `name` (one of COMMIT_CASES), from its own seed."""
    mode, B, kw = COMMIT_SPECS[name]
    return _commit_case(np.random.default_rng(
        [seed, COMMIT_CASES.index(name)]), mode, B, **kw)


def commit_cases(seed=0):
    """(name, case) for each mode and batch of COMMIT_BATCHES."""
    for name in COMMIT_CASES:
        yield name, commit_case(name, seed)


def commit_args(case, device):
    """The case as ring_commit's (args, kwargs) of tensors on `device`."""
    import torch
    T = lambda a: None if a is None else torch.as_tensor(a, device=device)
    chans = [(T(u), k, f, a, a2) for u, k, f, a, a2 in case["chans"]]
    kw = dict(valid_ch=case["valid_ch"], sort_ch=case["sort_ch"],
              nsel=case["nsel"], XK=case["XK"], app_I=case["app_I"],
              app_G=case["app_G"], envval=T(case["envval"]))
    if case.get("dmask") is not None:
        kw.update(dmask=T(case["dmask"]), XD=case["XD"])
    return (chans, T(case["x"]), T(case["base"]), T(case["app"])), kw


# views of an index array (numpy and torch spell these alike)
TPL_VIEWS = {
    "contiguous": lambda a: a,
    "offset1": lambda a: a.reshape(-1)[1:],
}


_TPL_SHAPES = (("contiguous", (7, 9, 4)), ("contiguous", (1023,)),
               ("offset1", (37, 13)), ("offset1", (4, 64)),
               ("contiguous", (5, 6, 10, 3)))
_TPL_COLS = ((0,), (8, 1, 8), tuple(range(12)), (11, 5, 2, 3))
# name -> (TP, view, base shape, columns)
TPL_CASES = {
    f"TP{TP}_{view}_{'x'.join(map(str, shape))}":
        (TP, view, shape, _TPL_COLS[(i + TP) % len(_TPL_COLS)])
    for TP in (1, 3, 1024) for i, (view, shape) in enumerate(_TPL_SHAPES)}


def tpl_case(name, seed=0):
    """The case `name` (a key of TPL_CASES), from its own seed: TP, a base
    index array, the view taken of it, the table and the columns."""
    TP, view, shape, cols = TPL_CASES[name]
    rng = np.random.default_rng([seed, list(TPL_CASES).index(name)])
    table = rng.standard_normal((TP, 12)).astype(np.float32) * 10
    idx = rng.integers(0, TP, shape).astype(np.int32)
    bad = rng.random(shape) < 0.1
    idx[bad] = rng.choice(np.int32([-1, TP, TP + 5, -2 ** 31, 2 ** 31 - 1]),
                          int(bad.sum()))
    return dict(TP=TP, base=idx, view=view, table=table, cols=cols)


def tpl_cases(seed=0):
    """(name, case) for each of TPL_CASES."""
    for name in TPL_CASES:
        yield name, tpl_case(name, seed)


def tpl_args(case, device):
    """The case as tpl_params' (tpl, table, cols) on `device`: tpl is the
    view of a tensor made from the base array."""
    import torch
    base = torch.as_tensor(case["base"], device=device)
    return (TPL_VIEWS[case["view"]](base),
            torch.as_tensor(case["table"], device=device), case["cols"])


# ---- K3 car_follow ---------------------------------------------------------

# the scalar parameters: maxspd, turnspd, upa, una, yld, maxneg, mingap,
# headway, maxpos, dt
FOLLOW_PRM = (16.67, 8.33, 2.0, 4.5, 5.0, 9.0, 2.5, 1.5, 2.0, 1.0)
FOLLOW_PRM_HALF = (11.11, 6.0, 2.5, 3.5, 4.0, 7.5, 2.0, 1.2, 3.0, 0.5)
# the uniform vehicle length
FOLLOW_LEN = 5.0
# (AP, IL or LPI, G): the approach rows; the link rows' (S, LPI, G); the
# lane rows' (S, N); the approach rows' in-lanes of the lane rows
_AP, _IL, _G = 3, 4, 5
_SK = 7
_SL, _NL, _ILG = 12, 9, 6


def _tpl_table(rng, TP):
    """(TP, 12) template parameters in plausible ranges (the columns of
    compiler/net.py P_*)."""
    lo_hi = ((0, 10), (3, 8), (2, 2), (1.5, 3), (5, 9), (1, 2.5), (2.5, 4.5),
             (1.5, 3), (8, 20), (1, 2), (3, 6), (5, 10))
    return np.stack([rng.uniform(lo, hi, TP) for lo, hi in lo_hi],
                    1).astype(np.float32)


def _tpl_idx(rng, shape, TP):
    """Template indices in [0, TP), about 8% of them -1, TP or far outside."""
    idx = rng.integers(0, TP, shape).astype(np.int32)
    bad = rng.random(shape) < 0.08
    idx[bad] = rng.choice(np.int32([-1, TP, TP + 5, -2 ** 31, 2 ** 31 - 1]),
                          int(bad.sum()))
    return idx


def _f32(rng, shape, lo, hi, wild=0.0, zero=0.0):
    """Uniform float32 in [lo, hi); a share `zero` of them 0, a share
    `wild` NaN or +-inf."""
    x = rng.uniform(lo, hi, shape).astype(np.float32)
    x[rng.random(shape) < zero] = 0.0
    w = rng.random(shape) < wild
    x[w] = rng.choice(np.float32([np.nan, np.inf, -np.inf]), int(w.sum()))
    return x


def _bool(rng, shape, p):
    return rng.random(shape) < p


def _stopped(inp, rng, prm):
    """A share of the rows stopped at the stop line with no distance left
    (speed 0, ff_d - dls - yld = 0, lane_left 0): stop_before_speed's 0 / 0,
    which isr_speed's std::min keeps out. Another share stopped exactly at
    their brake distance from the line (lane_left = the brake distance
    after accelerating: stop_before_speed's strict test)."""
    maxspd, _, upa, una, yld, _, _, _, _, dt = (np.float32(v) for v in prm)
    shape = inp["speed"].shape
    at = rng.random(shape) < 0.08
    inp["speed"][at] = 0.0
    inp["dls"][at] = 0.0
    inp["ff_d"][at] = yld
    inp["any_fail"][at] = True
    inp["isr_lane_left"][at] = 0.0
    nxt = np.float32(0.0) + upa * dt
    bda = (np.float32(0.0) + nxt) * dt / np.float32(2.0) \
        + (nxt * nxt / una / np.float32(2.0))
    at = (rng.random(shape) < 0.08) & ~at
    inp["speed"][at] = 0.0
    inp["isr_lane_left"][at] = bda


def _follow_case(rng, kind, B, TP=0, yld=False, raw=False, offset=False,
                 wild=0.0, mode=None, half=False, app="scalar", own=False):
    """One seeded K3 case: kind "isr" (mode 1), "chain" (mode 2), "mode3"
    (both) on approach-row shapes, "link" / "lane" in the ring-leader
    mode. A string input "@dis" / "@speed" is the ring's own array (as
    the ring paths pass it); with `own` the rows' speed (and a link row's
    dls) are arrays of their own instead."""
    prm = FOLLOW_PRM_HALF if half else FOLLOW_PRM
    case = dict(prm=prm, raw=raw, offset=offset, tpl=None, lead_tpl=None,
                table=None, ring=None)
    if TP:
        case["table"] = _tpl_table(rng, TP)
    inp = {}
    if kind in ("isr", "chain", "mode3"):
        shape = (_AP, _IL, _G, B)
        case["mode"] = {"isr": 1, "chain": 2, "mode3": 3}[kind]
        inp["speed"] = _f32(rng, shape, 0.0, 17.0, wild, zero=0.1)
        if case["mode"] & 1:
            inp.update(
                dls=_f32(rng, shape, -30.0, 5.0, wild),
                isr_lane_left=_f32(rng, shape, -5.0, 80.0, wild),
                any_fail=_bool(rng, shape, 0.3),
                ff_d=_f32(rng, shape, 0.0, 90.0, wild),
                app=True if app == "scalar" else _bool(rng, shape, 0.8),
                avail=_bool(rng, (_IL, _G, B), 0.5),
                can_enter=(_bool(rng, (_IL, _G, B), 0.5) if not TP
                           else _bool(rng, shape, 0.5)),
                turn=_bool(rng, (_IL, _G, 1), 0.4))
            _stopped(inp, rng, prm)
        if case["mode"] & 2:
            inp.update(
                gap=_f32(rng, shape, -5.0, 100.0, wild),
                lead_spd=_f32(rng, shape, 0.0, 17.0, wild, zero=0.1),
                has_lead=_bool(rng, shape, 0.8),
                isr_rel=_bool(rng, shape, 0.5),
                custom=_f32(rng, shape, 0.0, 17.0, wild),
                has_custom=_bool(rng, shape, 0.1),
                drv_maxspd=_f32(rng, (_IL, _G, B), 5.0, 20.0),
                invalid=_bool(rng, shape, 0.05),
                lane_left=_f32(rng, shape, -2.0, 300.0, wild))
            if case["mode"] == 2:
                inp["v_isr"] = _f32(rng, shape, 0.0, 20.0, wild)
        if TP:
            case["tpl"] = _tpl_idx(rng, shape, TP)
            if case["mode"] & 2:
                case["lead_tpl"] = _tpl_idx(rng, shape, TP)
    else:
        S, shape = ((_SK, (_SK, _IL, _G, B)) if kind == "link"
                    else (_SL, (_SL, _NL, B)))
        N = _IL * _G if kind == "link" else _NL
        n = rng.integers(0, S + 1, (N, B)).astype(np.int32)
        n[0] = 0                                    # an empty row
        n[1] = S                                    # a full one
        ring = dict(kind=kind, dis=_f32(rng, (S, N, B), 0.0, 300.0, wild),
                    speed=_f32(rng, (S, N, B), 0.0, 17.0, wild, zero=0.1),
                    n=n, tpl=_tpl_idx(rng, (S, N, B), TP) if TP else None,
                    len_row=_f32(rng, (N,), 50.0, 300.0),
                    lead_len=FOLLOW_LEN)
        case["mode"] = mode or (3 if kind == "link" else 2)
        inp.update(speed="@speed", isr_rel=case["mode"] == 3 or kind == "link",
                   custom=_f32(rng, shape, 0.0, 17.0, wild),
                   has_custom=_bool(rng, shape, 0.1))
        if own:
            inp["speed"] = _f32(rng, shape, 0.0, 17.0, wild, zero=0.1)
        if kind == "link":
            CE = 7 if TP else 6
            s0 = _f32(rng, (CE, N, B), 0.0, 100.0, wild)
            s0[5] = rng.choice(np.float32([0.0, 1.0, 0.3, 0.7, 0.5]),
                               (N, B), p=[0.3, 0.4, 0.1, 0.1, 0.1])
            if TP:
                s0[6] = _tpl_idx(rng, (N, B), TP).astype(np.float32)
            ring["s0"] = s0
            inp.update(drv_maxspd=10000.0, invalid=False, lane_left=0.0)
            if case["mode"] & 1:
                inp.update(dls=_f32(rng, shape, 0.0, 300.0) if own else "@dis",
                           isr_lane_left=0.0,
                           any_fail=_bool(rng, shape, 0.3),
                           ff_d=_f32(rng, shape, 0.0, 90.0, wild),
                           app=False, avail=_bool(rng, (_IL, _G, B), 0.5),
                           can_enter=_bool(rng, (_IL, _G, B), 0.5),
                           turn=_bool(rng, (_IL, _G, 1), 0.4))
            else:
                inp["v_isr"] = _f32(rng, shape, 0.0, 20.0, wild)
        else:
            inv = rng.integers(0, _ILG, _NL).astype(np.int32)
            inv[::3] = -1                           # lanes without an in-lane
            ring.update(nxt=rng.integers(-1, 4, (S, N, B)).astype(np.int32),
                        last=_bool(rng, (S, N, B), 0.3), in_inv=inv,
                        ap_v=_f32(rng, (_AP, _ILG, B), 0.0, 17.0, wild),
                        ap_d=None if raw
                        else _f32(rng, (_AP, _ILG, B), 0.0, 300.0),
                        ap_rel=_bool(rng, (_AP, _ILG, B), 0.5))
            inp.update(v_isr=0.0, isr_rel=False,
                       drv_maxspd=_f32(rng, (N, 1), 5.0, 20.0))
        if TP:
            case["tpl"] = "@tpl"
        case["ring"] = ring
    if yld:
        inp["v_yield"] = _f32(rng, shape, 0.0, 20.0, wild)
    case.update(shape=shape, inp=inp)
    return case


# name -> (kind, B, keywords of _follow_case)
FOLLOW_SPECS = {
    "isr_B128": ("isr", 128, {}),
    "isr_tpl100_B130": ("isr", 130, dict(TP=100, half=True)),
    "isr_B3_offset": ("isr", 3, dict(offset=True, app="full")),
    "isr_B128_wild": ("isr", 128, dict(wild=0.03, app="full")),
    "chain_B128": ("chain", 128, {}),
    "chain_yield_raw_B128": ("chain", 128, dict(yld=True, raw=True)),
    "chain_tpl3_B1": ("chain", 1, dict(TP=3)),
    "chain_tpl100_yield_raw_B130": ("chain", 130, dict(TP=100, yld=True,
                                                       raw=True, half=True)),
    "chain_raw_B3_offset": ("chain", 3, dict(raw=True, offset=True)),
    "mode3_B128_wild": ("mode3", 128, dict(wild=0.03)),
    "mode3_tpl3_B3": ("mode3", 3, dict(TP=3)),
    "link_B128": ("link", 128, {}),
    "link_B130_wild": ("link", 130, dict(wild=0.03, half=True)),
    "link_tpl100_B128": ("link", 128, dict(TP=100)),
    "link_tpl3_B1": ("link", 1, dict(TP=3)),
    "link_mode2_raw_B3": ("link", 3, dict(mode=2, raw=True)),
    "link_B128_offset": ("link", 128, dict(offset=True)),
    "lane_B128": ("lane", 128, {}),
    "lane_raw_yield_B128": ("lane", 128, dict(yld=True, raw=True)),
    "lane_B130_wild": ("lane", 130, dict(wild=0.03, half=True)),
    "lane_tpl3_B3": ("lane", 3, dict(TP=3)),
    "lane_tpl100_yield_raw_B130": ("lane", 130, dict(TP=100, yld=True,
                                                     raw=True)),
    "lane_tpl100_B128_wild": ("lane", 128, dict(TP=100, wild=0.02)),
    "lane_B1": ("lane", 1, {}),
    "lane_raw_B128_offset": ("lane", 128, dict(raw=True, offset=True)),
    "lane_B128_own": ("lane", 128, dict(own=True)),
    "link_tpl3_B128_own": ("link", 128, dict(TP=3, own=True)),
}
FOLLOW_CASES = tuple(FOLLOW_SPECS)


def follow_case(name, seed=0):
    """The K3 case `name` (one of FOLLOW_CASES), from its own seed."""
    kind, B, kw = FOLLOW_SPECS[name]
    return _follow_case(np.random.default_rng(
        [seed, 1000 + FOLLOW_CASES.index(name)]), kind, B, **kw)


def follow_cases(seed=0):
    """(name, case) for each of FOLLOW_CASES."""
    for name in FOLLOW_CASES:
        yield name, follow_case(name, seed)


def _tensor(a, device, offset=False):
    """`a` as a tensor on `device`; with `offset` a view one element into
    a larger buffer (contiguous, not 16-byte aligned)."""
    import torch
    t = torch.as_tensor(a, device=device)
    if not offset or t.dim() == 0:
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    return v


def follow_args(case, device):
    """The case as car_follow's (args, kwargs) of tensors on `device`."""
    from cityflow_tpu_torch.kernels.car_follow import RingLeaders
    off = case["offset"]
    T = lambda a: None if a is None else _tensor(a, device, off)
    r = case["ring"]
    ring = None
    if r is not None:
        ring = RingLeaders(**{k: (T(v) if isinstance(v, np.ndarray) else v)
                              for k, v in r.items()})
    shape = case["shape"]

    def val(v):
        if isinstance(v, str):
            return getattr(ring, v[1:]).reshape(shape)
        return T(v) if isinstance(v, np.ndarray) else v
    kw = {k: val(v) for k, v in case["inp"].items()}
    kw.update(raw=case["raw"], ring=ring)
    if case["table"] is not None:
        kw.update(tpl=val(case["tpl"]), table=T(case["table"]))
        if case["lead_tpl"] is not None:
            kw["lead_tpl"] = T(case["lead_tpl"])
    return (case["mode"], case["prm"], shape), kw


# ---- K2 cross_caps ---------------------------------------------------------

# maxneg, yld, len, turnspd, maxspd, upa, dt
CAPS_PRM = (9.0, 5.0, 5.0, 8.33, 16.67, 2.0, 1.0)
_LK = 24


def _caps_case(rng, R, KC, B, TP=0, app=False, far=False):
    """One seeded K2 case on LK = 24 links: distances, enter times and
    priorities from small sets, so crosses tie in distance, rows tie with
    their foes in reach, distance, enter time and the priority's high half;
    with `far` the crosses lie thousands of metres out (reach steps above
    255)."""
    LK, NF = _LK, KC * _LK
    step = rng.choice(np.float32([0.0, 0.0, 2.5, 5.0, 10.0]), (KC, LK))
    d = (np.cumsum(step, 0) + rng.choice(np.float32([0.0, 2.5, 5.0]), LK))
    if far:
        d = d * np.float32(400.0)
    d = d.astype(np.float32)
    cvalid = rng.random((KC, LK)) < 0.85
    cvalid[KC // 2:, ::5] = False                 # padded tails
    foe_src = rng.integers(0, NF, (KC, LK)).astype(np.int32)
    foe_src[rng.random((KC, LK)) < 0.2] = -1
    tabs = dict(d=d, cvalid=cvalid,
                t2=rng.integers(0, 3, (KC, LK)).astype(np.int32),
                foelpi=rng.integers(0, 12, (KC, LK)).astype(np.int32),
                t1=rng.integers(0, 3, LK).astype(np.int32),
                turn=rng.random(LK) < 0.4)
    rows = (R, LK, B)
    dls = rng.choice(np.float32([-5.0, 0.0, 2.5, 5.0, 10.0, 20.0]), rows)
    speed = _f32(rng, rows, 0.0, 17.0, zero=0.1)
    if far:
        speed[rng.random(rows) < 0.3] = np.float32(0.001)
    ent = 5.0 if app else rng.choice(np.float32([0, 5, 10]), rows)
    ph = rng.choice(np.float32([-1, 0, 1]), rows)
    plo = rng.choice(np.float32([0, 1, 2, 3]), rows)
    rel = rng.random(rows) < 0.6
    rel[:, 0] = False                              # a column nobody considers
    fields = np.stack([
        rng.choice(np.float32([0.0, 1.0, 0.5, 0.7]), (NF, B),
                   p=[0.2, 0.6, 0.1, 0.1]),
        *(rng.choice(np.float32([0.0, 1.0]), (NF, B)) for _ in range(3)),
        rng.choice(np.float32([0, 1, 2, 3, 4, 5, 8, 255, 300]), (NF, B)),
        rng.choice(np.float32([-5.0, 0.0, 2.5, 5.0, 10.0, 20.0]), (NF, B)),
        rng.choice(np.float32([0, 5, 10]), (NF, B)),
        rng.choice(np.float32([-1, 0, 1]), (NF, B)),
        rng.choice(np.float32([0, 1, 2, 3]), (NF, B))])
    case = dict(dls=dls, speed=speed, ent=ent, ph=ph, plo=plo, rel=rel,
                fields=fields, foe_src=foe_src.reshape(-1), tabs=tabs,
                prm=CAPS_PRM, tpl=None, table=None)
    if TP:
        case.update(tpl=_tpl_idx(rng, rows, TP), table=_tpl_table(rng, TP))
    return case


# name -> (R, KC, B, keywords of _caps_case)
CAPS_SPECS = {
    "R4_KC20_B128": (4, 20, 128, {}),
    "R3_KC20_B130_app": (3, 20, 130, dict(app=True)),
    "R1_KC1_B1": (1, 1, 1, {}),
    "R2_KC5_B3_tpl3": (2, 5, 3, dict(TP=3)),
    "R4_KC20_B33_tpl5": (4, 20, 33, dict(TP=5)),
    "R3_KC20_B128_tpl3_app": (3, 20, 128, dict(TP=3, app=True)),
    "R4_KC20_B130_far": (4, 20, 130, dict(far=True)),
    "R2_KC1_B128": (2, 1, 128, {}),
}
CAPS_CASES = tuple(CAPS_SPECS)


def caps_case(name, seed=0):
    """The K2 case `name` (one of CAPS_CASES), from its own seed."""
    R, KC, B, kw = CAPS_SPECS[name]
    return _caps_case(np.random.default_rng(
        [seed, 2000 + CAPS_CASES.index(name)]), R, KC, B, **kw)


def caps_cases(seed=0):
    """(name, case) for each of CAPS_CASES."""
    for name in CAPS_CASES:
        yield name, caps_case(name, seed)


def caps_args(case, device):
    """The case as cross_caps' (args, kwargs) on `device`."""
    import torch
    T = lambda a: torch.as_tensor(a, device=device)
    ent = case["ent"]
    args = (T(case["dls"]), T(case["speed"]),
            T(ent) if isinstance(ent, np.ndarray) else ent, T(case["ph"]),
            T(case["plo"]), T(case["rel"]), T(case["fields"]),
            T(case["foe_src"]), {k: T(v) for k, v in case["tabs"].items()},
            case["prm"])
    kw = {} if case["tpl"] is None else dict(tpl=T(case["tpl"]),
                                             table=T(case["table"]))
    return args, kw


# ---- L2 lc_receive ---------------------------------------------------------

# (maxNegAcc, interval)
RECEIVE_PRM = (4.5, 1.0)
RECEIVE_PRM_HALF = (3.5, 0.5)
_RN = 9
# priorities: equal ones, pairs that differ only in the high half, the
# int32 extremes and negatives
_PRI = np.int32([0, 3, 3, 7, 5 | (1 << 16), 5 | (2 << 16), 5 | (3 << 16),
                 -(1 << 16) | 5, -5, -(2 ** 31), 2 ** 31 - 1, 0x12340000,
                 0x12350000])


def _receive_case(rng, B, S, TP=0, half=False):
    """One seeded L2 case on _RN = 9 lanes. Lane 0 has no inner neighbour,
    lane 1 no outer one, lane 2 neither; column 3 is empty and column 4
    full in every env; lane 5 (no outer neighbour) has column 6 as its
    inner one, which aims every occupied row at receiver c (leader role)
    and c + 1 (follower role) with one priority: the first sender must
    win both. Plan
    is set only on occupied rows, as L1 gives it."""
    N = _RN
    shape = (S, N, B)
    inner = rng.integers(0, N, N).astype(np.int32)
    outer = rng.integers(0, N, N).astype(np.int32)
    inner[0] = outer[1] = inner[2] = outer[2] = -1
    inner[5], outer[5] = 6, -1
    n_l = rng.integers(0, S + 1, (N, B)).astype(np.int32)
    n_l[3] = 0
    n_l[4] = n_l[6] = S
    occ = np.arange(S)[:, None, None] < n_l[None]
    plan = occ & (rng.random(shape) < 0.5)
    dirc = rng.choice(np.int32([-1, 0, 1]), shape, p=[0.4, 0.2, 0.4])
    # target slots around the ring's: -1 (leader role nowhere, follower
    # slot 0), S - 1 (the follower slot falls off the ring), S and far out
    tl = rng.integers(-1, S + 1, shape).astype(np.int32)
    far = rng.random(shape) < 0.03
    tl[far] = rng.choice(np.int32([S + 5, -7, 2 ** 31 - 1, -(2 ** 31)]),
                         int(far.sum()))
    tl[rng.random(shape) < 0.05] = S - 1
    pri = rng.choice(_PRI, shape)
    # the crowd: column 6 aims every occupied row at slots c, c + 1 of
    # lane 5
    c = max(S // 2 - 1, 0)
    plan[:, 6] = occ[:, 6]
    dirc[:, 6] = 1
    tl[:, 6] = c
    pri[:, 6] = 7
    hsig = rng.random(shape) < 0.5
    chg = rng.random(shape) < 0.15
    case = dict(plan=plan, dirc=dirc, tl_slot=tl,
                ygap=_f32(rng, shape, -20.0, 80.0, wild=0.0),
                hsig=hsig, gval=rng.random(shape) < 0.7,
                speed=_f32(rng, shape, 0.0, 17.0, zero=0.1), pri=pri,
                n_l=n_l, chg=chg, inner_src=inner, outer_src=outer,
                prm=RECEIVE_PRM_HALF if half else RECEIVE_PRM, tpl=None,
                table=None, crowd=(5, c))
    # a sender with no follower behind it yields at an infinite gap
    case["ygap"][rng.random(shape) < 0.05] = np.inf
    if TP:
        case.update(tpl=_tpl_idx(rng, shape, TP), table=_tpl_table(rng, TP))
    return case


# name -> (B, S, keywords of _receive_case)
RECEIVE_SPECS = {
    "B1_S40": (1, 40, {}),
    "B3_S40": (3, 40, dict(half=True)),
    "B128_S40": (128, 40, {}),
    "B130_S40_tpl3": (130, 40, dict(TP=3)),
    "B1_S1": (1, 1, {}),
    "B128_S1_tpl3": (128, 1, dict(TP=3)),
    "B3_S130": (3, 130, {}),
    "B130_S100_tpl3": (130, 100, dict(TP=3, half=True)),
}
RECEIVE_CASES = tuple(RECEIVE_SPECS)


def receive_case(name, seed=0):
    """The L2 case `name` (one of RECEIVE_CASES), from its own seed."""
    B, S, kw = RECEIVE_SPECS[name]
    return _receive_case(np.random.default_rng(
        [seed, 3000 + RECEIVE_CASES.index(name)]), B, S, **kw)


def receive_cases(seed=0):
    """(name, case) for each of RECEIVE_CASES."""
    for name in RECEIVE_CASES:
        yield name, receive_case(name, seed)


def receive_args(case, device):
    """The case as lc_receive's (args, kwargs) on `device`."""
    import torch
    T = lambda a: torch.as_tensor(a, device=device)
    args = tuple(T(case[k]) for k in (
        "plan", "dirc", "tl_slot", "ygap", "hsig", "gval", "speed", "pri",
        "n_l", "chg")) + (
        {k: T(case[k]) for k in ("inner_src", "outer_src")}, case["prm"])
    kw = {} if case["tpl"] is None else dict(tpl=T(case["tpl"]),
                                             table=T(case["table"]))
    return args, kw


# ---- G12 admit_heads -------------------------------------------------------

_P_LEN, _P_MINGAP = 1, 7


def _admit_case(rng, B, V, L, fp, offset=False):
    """One seeded G12 case: B envs of V slots over L lanes (D = L + 3
    drivables). Lane 0 holds many waiting slots, lane 1 one, lane 2 a
    least uid held by three waiting slots (between them a waiting slot of
    that uid in another lane and a running one), lane 3 none, lane 5 two
    waiting slots of uid INT32_MAX; uids near INT32_MAX and negative; some
    tails -1, and lane 4's tail stands at exactly len + the head's minGap
    (not available)."""
    dt = np.float32 if fp == "f32" else np.float64
    D = L + 3
    active = rng.random((B, V)) < 0.8
    running = active & (rng.random((B, V)) < 0.7)
    waiting = active & ~running
    drv = rng.integers(-1, D, (B, V)).astype(np.int32)
    lanes = rng.choice(np.arange(L), (B, V),
                       p=np.r_[0.3, np.full(L - 1, 0.7 / (L - 1))])
    drv = np.where(waiting, lanes, drv).astype(np.int32)
    uid = rng.integers(-50, 5000, (B, V)).astype(np.int32)
    big = rng.random((B, V)) < 0.05
    uid[big] = rng.choice(np.int32([2 ** 31 - 1, 2 ** 31 - 2,
                                    -(2 ** 31) + 1]), int(big.sum()))
    # lane 3 empty, lane 1 one waiting slot (slot V - 1: not a multiple of
    # the vector width when V is not)
    for lane in (1, 2, 3, 5):
        drv[waiting & (drv == lane)] = 0
    w1 = V - 1
    active[:, w1], running[:, w1], drv[:, w1] = True, False, 1
    # lane 2: uid -(2^31) + 3 (below every other) at three slots, with a
    # waiting slot of that uid in lane 0 and a running one in between
    u2 = np.int32(-(2 ** 31) + 3)
    for v, (act, run, lane) in zip(
            (2, 5, 6, 7, 9), ((1, 0, 2), (1, 0, 0), (1, 1, 2), (1, 0, 2),
                              (1, 0, 2))):
        active[:, v], running[:, v], drv[:, v], uid[:, v] = act, run, \
            lane, u2
    # lane 5: uid INT32_MAX (the plain version's "none") at two slots
    active[:, 16:18], running[:, 16:18], drv[:, 16:18] = True, False, 5
    uid[:, 16:18] = 2 ** 31 - 1
    # lane 4's head: slot 11 with the least uid of that lane
    active[:, 11], running[:, 11], drv[:, 11] = True, False, 4
    uid[:, 11] = -(2 ** 31)
    dis = rng.uniform(0.0, 300.0, (B, V)).astype(dt)
    params = rng.uniform(0.5, 10.0, (B, V, 12)).astype(dt)
    last_of = np.where(rng.random((B, D)) < 0.3, -1,
                       rng.integers(0, V, (B, D))).astype(np.int32)
    # lane 4's tail at slot 12: dis = len + the head's minGap exactly; in
    # odd envs one ulp above (available)
    last_of[:, 4] = 12
    edge = (params[:, 12, _P_LEN] + params[:, 11, _P_MINGAP]).astype(dt)
    dis[:, 12] = edge
    dis[1::2, 12] = np.nextafter(edge[1::2], dt(np.inf))
    # lane 0's and 2's tails far back: available
    for lane, t in ((0, 13), (2, 14)):
        last_of[:, lane] = t
        dis[:, t] = params[:, t, _P_LEN] + dt(50.0)
    return dict(
        active=active, running=running, drv=drv, uid=uid, dis=dis,
        params=params,
        leader=rng.integers(-1, V, (B, V)).astype(np.int32),
        gap=rng.uniform(-5.0, 200.0, (B, V)).astype(dt),
        list_seq=rng.integers(0, 10 ** 6, (B, V)).astype(np.int32),
        last_of=last_of,
        seq_counter=rng.integers(0, 2 ** 31 - 1, B).astype(np.int32),
        L=L, offset=offset)


# name -> (B, V, L, float type, keywords of _admit_case)
ADMIT_SPECS = {
    "B1_V37_f64": (1, 37, 6, "f64", {}),
    "B3_V130_f32": (3, 130, 9, "f32", {}),
    "B128_V1001_f32": (128, 1001, 40, "f32", {}),
    "B130_V256_f64": (130, 256, 24, "f64", {}),
    "B128_V512_f64": (128, 512, 40, "f64", {}),
    "B130_V1001_f32": (130, 1001, 40, "f32", {}),
    "B3_V64_f32_offset": (3, 64, 7, "f32", dict(offset=True)),
    "B1_V257_f64_offset": (1, 257, 8, "f64", dict(offset=True)),
}
ADMIT_CASES = tuple(ADMIT_SPECS)


def admit_case(name, seed=0):
    """The G12 case `name` (one of ADMIT_CASES), from its own seed."""
    B, V, L, fp, kw = ADMIT_SPECS[name]
    return _admit_case(np.random.default_rng(
        [seed, 4000 + ADMIT_CASES.index(name)]), B, V, L, fp, **kw)


def admit_cases(seed=0):
    """(name, case) for each of ADMIT_CASES."""
    for name in ADMIT_CASES:
        yield name, admit_case(name, seed)


def admit_args(case, device):
    """The case as admit_heads' arguments on `device`; with `offset` every
    tensor a view one element into a larger buffer (contiguous, not
    16-byte aligned)."""
    return tuple(_tensor(case[k], device, case["offset"]) for k in (
        "active", "running", "drv", "uid", "dis", "params", "leader", "gap",
        "list_seq", "last_of", "seq_counter")) + (case["L"],)


# ---- L3 lc_insert and L1 lc_signal -----------------------------------------

# roads of adjacent lane columns: (first column, lanes, llocal of the first).
# The neighbour tables are the compiler's (inner = the column before in the
# road, outer = the one after), so symmetric; road A's lane indices start
# at -1 and road B has more lanes than MAXLPR = 3 route rows, so some
# senders' target lane index lies outside [0, M); road C is one lane (no
# neighbour on either side)
_ROADS = ((0, 3, -1), (3, 4, 0), (7, 1, 0), (8, 2, 1))
_LN = 10
_LC_M = 3


def _lane_tables():
    """(inner_src, outer_src, ln_llocal) of the _ROADS lanes."""
    inner = np.full(_LN, -1, np.int32)
    outer = np.full(_LN, -1, np.int32)
    llocal = np.zeros(_LN, np.int32)
    for first, n, lo0 in _ROADS:
        for i in range(n):
            llocal[first + i] = lo0 + i
            if i > 0:
                inner[first + i] = first + i - 1
            if i < n - 1:
                outer[first + i] = first + i + 1
    return inner, outer, llocal


def _directions(rng, shape, inner, outer):
    """-1 / 0 / +1 per row, only toward a neighbour the lane has."""
    d = rng.choice(np.int32([-1, 0, 1]), shape, p=[0.4, 0.2, 0.4])
    d[(d > 0) & (outer < 0)[None, :, None]] = 0
    d[(d < 0) & (inner < 0)[None, :, None]] = 0
    return d


# distances from a small set: ties between senders, and between a winner
# and a row of its target lane
_DIS_SET = np.float32([0.0, -0.0, 2.5, 7.0, 7.0, 12.25, 30.0, 55.5])


def _insert_case(rng, B, S, LCI, TP=0):
    """One seeded L3 case on the _ROADS lanes. Lane 4 (inner 3, outer 5)
    is full in odd envs (its winners refused: overflow bit 2, and they
    start all the same, as the TPU form does); column 3 is a crowd, every
    occupied row of it sending +1 into lane 4 (more candidates than LCI:
    overflow bit 1); lane 7 has no neighbour. Distances from _DIS_SET and
    uniform, a few NaN and -inf (never winners, but candidates). As L1 and
    L2 leave them: do_change on occupied rows with a direction toward an
    existing neighbour, l_dir 0 on rows neither shadow nor changing, dirc
    = l_dir on changing rows that are not shadows."""
    N, M = _LN, _LC_M
    inner, outer, llocal = _lane_tables()
    shape = (S, N, B)
    n_l = rng.integers(0, S + 1, (N, B)).astype(np.int32)
    n_l[4, 1::2] = S
    n_l[7, ::2] = 0
    occ = np.arange(S)[:, None, None] < n_l[None]
    dis = rng.choice(_DIS_SET, shape)
    dis = np.where(rng.random(shape) < 0.5,
                   rng.uniform(0.0, 60.0, shape).astype(np.float32), dis)
    w = rng.random(shape) < 0.03
    dis[w] = rng.choice(np.float32([np.nan, -np.inf]), int(w.sum()))
    dirc = _directions(rng, shape, inner, outer)
    sh = rng.random(shape) < 0.15
    chg = rng.random(shape) < 0.15
    l_dir = np.where(sh, rng.choice(np.int32([-1, 1]), shape),
                     _directions(rng, shape, inner, outer)).astype(np.int32)
    l_dir[~sh & ~chg] = 0
    dirc = np.where(chg & ~sh, l_dir, dirc).astype(np.int32)
    do_change = occ & (rng.random(shape) < 0.35) & (dirc != 0)
    # the crowd
    do_change[:, 3] = occ[:, 3]
    dirc[:, 3] = 1
    sh[:, 3] = chg[:, 3] = False
    l_dir[:, 3] = 0
    ints = lambda lo, hi: rng.integers(lo, hi, shape).astype(np.int32)
    uid = ints(0, 5000)
    uid[rng.random(shape) < 0.05] = 2 ** 31 - 1     # SHBIT + uid wraps
    ch = dict(dis=dis, speed=_f32(rng, shape, 0.0, 17.0, zero=0.1),
              flow=ints(-1, 40), route=ints(-1, 400), rpos=ints(0, 31),
              nxt=ints(-1, 100), nxt3=ints(-1, 100), prev=ints(-1, 50),
              enter=_f32(rng, shape, 0.0, 3600.0),
              pri=rng.choice(_PRI, shape), uid=uid,
              last=_bool(rng, shape, 0.3),
              gap=_f32(rng, shape, -5.0, 100.0, wild=0.02),
              dir=l_dir, off=_f32(rng, shape, -3.0, 3.0), sh=sh, chg=chg,
              custom=_f32(rng, shape, 0.0, 20.0),
              hascustom=_bool(rng, shape, 0.1),
              rnrow=rng.integers(-1, 60, (M,) + shape).astype(np.int32),
              auxrow=rng.integers(-3, 250, (M,) + shape).astype(np.int32))
    if TP:
        ch["tpl"] = _tpl_idx(rng, shape, TP)
    return dict(ch=ch, do_change=do_change, dirc=dirc,
                yv=_f32(rng, shape, 0.0, 100.0), n_l=n_l, inner_src=inner,
                outer_src=outer, ln_llocal=llocal, LCI=LCI)


# name -> (B, S, LCI, keywords of _insert_case)
INSERT_SPECS = {
    "B1_S40_L2": (1, 40, 2, {}),
    "B3_S40_L1": (3, 40, 1, {}),
    "B128_S40_L2": (128, 40, 2, {}),
    "B130_S40_L4_tpl3": (130, 40, 4, dict(TP=3)),
    "B3_S12_L8": (3, 12, 8, {}),
    "B128_S40_L8_tpl3": (128, 40, 8, dict(TP=3)),
    "B130_S40_L3": (130, 40, 3, {}),
    "B1_S5_L4_tpl3": (1, 5, 4, dict(TP=3)),
}
INSERT_CASES = tuple(INSERT_SPECS)


def insert_case(name, seed=0):
    """The L3 case `name` (one of INSERT_CASES), from its own seed."""
    B, S, LCI, kw = INSERT_SPECS[name]
    return _insert_case(np.random.default_rng(
        [seed, 5000 + INSERT_CASES.index(name)]), B, S, LCI, **kw)


def insert_cases(seed=0):
    """(name, case) for each of INSERT_CASES."""
    for name in INSERT_CASES:
        yield name, insert_case(name, seed)


def insert_args(case, device):
    """The case as lc_insert's arguments on `device`, every tensor a fresh
    copy (L3 writes its leaves, yv and n_l in place)."""
    import torch
    T = lambda a: torch.tensor(a, device=device)
    return ({k: T(v) for k, v in case["ch"].items()}, T(case["do_change"]),
            T(case["dirc"]), T(case["yv"]), T(case["n_l"]),
            {k: T(case[k]) for k in ("inner_src", "outer_src", "ln_llocal")},
            case["LCI"])


# (len, maxNegAcc, maxSpeed, interval)
SIGNAL_PRM = (5.0, 4.5, 16.67, 1.0)
SIGNAL_PRM_HALF = (4.0, 3.5, 11.11, 0.5)
_KOUT = 3


def _signal_case(rng, B, S, TP=0, half=False):
    """One seeded L1 case on the _ROADS lanes. Each column's occupied rows
    hold distances from the lane's length down, in the ring's order, but
    in about 15% of the (column, env) pairs shuffled, in about 5% with a
    NaN, some ties and -0.0 next to 0.0; the rows past n_l hold anything.
    Column 6 (lane 5's outer neighbour) is empty in every env, column 4
    full. Stale gaps around the signal's thresholds, envs before and after
    the cooling time, out-link ring tails present and absent, some of them
    closer than a vehicle length (the tail branch's short gap)."""
    N, M = _LN, _LC_M
    inner, outer, llocal = _lane_tables()
    shape = (S, N, B)
    prm = SIGNAL_PRM_HALF if half else SIGNAL_PRM
    ln_len = rng.uniform(60.0, 400.0, N).astype(np.float32)
    n_l = rng.integers(0, S + 1, (N, B)).astype(np.int32)
    n_l[6] = 0
    n_l[4] = S
    occ = np.arange(S)[:, None, None] < n_l[None]
    frac = np.sort(rng.random(shape), axis=0)[::-1]
    dis = (frac * ln_len[None, :, None]).astype(np.float32)
    tie = rng.random(shape) < 0.2
    dis[tie] = np.round(dis[tie] / 4.0) * 4.0
    dis[-(S // 4 or 1):][rng.random((S // 4 or 1, N, B)) < 0.3] = 0.0
    for p in range(N):
        for b in range(B):
            n = n_l[p, b]
            if n > 1 and rng.random() < 0.15:
                dis[:n, p, b] = rng.permutation(dis[:n, p, b])
            if n > 0 and rng.random() < 0.05:
                dis[rng.integers(0, n), p, b] = np.nan
    dis[(dis == 0.0) & (rng.random(shape) < 0.5)] = -0.0
    junk = rng.uniform(-50.0, 450.0, shape).astype(np.float32)
    dis = np.where(occ, dis, junk)
    sh = rng.random(shape) < 0.1
    chg = rng.random(shape) < 0.15
    expected = 2 * prm[0] + 4 * prm[3] * prm[2]
    case = dict(
        dis=dis, speed=_f32(rng, shape, 0.0, 17.0, zero=0.15), n_l=n_l,
        sh=sh, chg=chg,
        l_dir=rng.choice(np.int32([-1, 0, 1]), shape),
        l_gap=_f32(rng, shape, 0.0, 1.3 * expected, wild=0.02),
        l_last=_bool(rng, shape, 0.3),
        rnrow=rng.integers(-1, 9, (M,) + shape).astype(np.int32),
        olt_dis=_f32(rng, (_KOUT, N, B), -40.0, 60.0, wild=0.03),
        olt_ex=_bool(rng, (_KOUT, N, B), 0.6),
        now=rng.choice(np.float32([0.0, 2.5, 3.0, 100.0, 1234.5]), B),
        inner_src=inner, outer_src=outer, ln_len=ln_len, ln_llocal=llocal,
        prm=prm, tpl=None, table=None, olt_len=None)
    case["olt_ex"][:, 2] = False            # lane 2: no out-link tail
    if TP:
        case.update(tpl=_tpl_idx(rng, shape, TP), table=_tpl_table(rng, TP),
                    olt_len=_f32(rng, (_KOUT, N, B), 2.0, 9.0))
    return case


# name -> (B, S, keywords of _signal_case)
SIGNAL_SPECS = {
    "B1_S40": (1, 40, {}),
    "B3_S40_half": (3, 40, dict(half=True)),
    "B128_S40": (128, 40, {}),
    "B130_S40_tpl3": (130, 40, dict(TP=3)),
    "B3_S1": (3, 1, {}),
    "B128_S40_tpl3_half": (128, 40, dict(TP=3, half=True)),
    "B130_S200": (130, 200, {}),
    "B1_S12_tpl3": (1, 12, dict(TP=3)),
}
SIGNAL_CASES = tuple(SIGNAL_SPECS)


def signal_case(name, seed=0):
    """The L1 case `name` (one of SIGNAL_CASES), from its own seed."""
    B, S, kw = SIGNAL_SPECS[name]
    return _signal_case(np.random.default_rng(
        [seed, 6000 + SIGNAL_CASES.index(name)]), B, S, **kw)


def signal_cases(seed=0):
    """(name, case) for each of SIGNAL_CASES."""
    for name in SIGNAL_CASES:
        yield name, signal_case(name, seed)


def signal_args(case, device):
    """The case as lc_signal's (args, kwargs) on `device`."""
    import torch
    T = lambda a: torch.as_tensor(a, device=device)
    args = tuple(T(case[k]) for k in (
        "dis", "speed", "n_l", "sh", "chg", "l_dir", "l_gap", "l_last",
        "rnrow", "olt_dis", "olt_ex", "now")) + (
        {k: T(case[k]) for k in ("inner_src", "outer_src", "ln_len",
                                 "ln_llocal")}, case["prm"])
    kw = {} if case["tpl"] is None else {
        k: T(case[k]) for k in ("tpl", "table", "olt_len")}
    return args, kw


# ---- G4 cross_pass ---------------------------------------------------------

# the vehicle parameter columns G4 reads (compiler/net.py P_*) and a base
# vehicle: len, maxNegAcc, usualPosAcc, usualNegAcc, maxSpeed, yieldDistance,
# turnSpeed
_CP_COLS = (1, 4, 5, 6, 8, 10, 11)
_CP_BASE = (5.0, 4.5, 2.5, 2.5, 16.0, 5.0, 8.0)
# own-side table values of a crafted cross (keys of notify_cross.OWN)
_NO_FOE = dict(exists=False)
_YIELD_NOW = dict(exists=True, **{"yield": False}, cyc=False)   # fails
_CYCLE = dict(exists=True, **{"yield": False}, cyc=True)        # passes


def _tie(**kw):
    """A foe at the cross on the same reach step (3), types equal."""
    return dict(dict(exists=True, **{"yield": True}, dpos=True, cyc=False,
                     reach=3, cleared=True), **kw)


# crafted vehicles, one a slot from slot 0 on, each on its own lanelink
# row: (vehicle fields, row type, [(cd, foetype, own values, valid), ...])
# (a cross list longer than KC is cut: its last failure moves to KC - 1)
def _cp_crafts(KC):
    base = dict(speed=1.0, dls=-10.0, ent=2, pri=3, blk_ok=True)
    tie = dict(speed=10.0, dls=0.0, maxspd=8.0, ent=2, pri=3, blk_ok=True)
    fail_last = [(2.0 + k, 2, _NO_FOE, True) for k in range(KC - 1)] + [
        (2.0 + KC, 2, _YIELD_NOW, True)]
    return [
        (dict(base, the_ll=-1), 2, []),                       # no lanelink
        (base, 2, fail_last),                                 # fails at KC-1
        (dict(base, blk_ok=False), 2,                         # fails at 0,
         [(3.0, 2, _YIELD_NOW, True)]),                       # no blocker
        (base, 2, [(2.0 + k, 2, _CYCLE, True)                 # no failure
                   for k in range(KC)]),
        (tie, 2, [(25.0, 2, _tie(ent=3), True)]),             # ent: pass
        (tie, 2, [(25.0, 2, _tie(ent=1), True)]),             # ent: fail
        (tie, 2, [(25.0, 2, _tie(ent=2, dist=30.0), True)]),  # dist: pass
        (tie, 2, [(25.0, 2, _tie(ent=2, dist=20.0), True)]),  # dist: fail
        (tie, 2, [(25.0, 2, _tie(ent=2, dist=25.0, pri=2), True)]),  # pri
        (tie, 2, [(25.0, 2, _tie(ent=2, dist=25.0, pri=3), True)]),  # pri
        (base, 2, [                                           # the types
            (3.0, 1, dict(exists=True, **{"yield": True}), True),
            (4.0, 3, dict(exists=True, **{"yield": True}, dpos=False,
                          cleared=True), True),
            (5.0, 3, dict(exists=True, **{"yield": True}, dpos=False,
                          cleared=False, cyc=True), True),
            (6.0, 2, dict(exists=True, **{"yield": True}, dpos=False,
                          cleared=False, cyc=False), True)]),
        (tie, 1, [                                            # t1 < t2 on
            (25.0, 2, _tie(reach=4), True),                   # reach steps
            (31.0, 2, _tie(reach=4, cyc=True), True),
            (35.0, 2, _tie(reach=2), True)]),
        (dict(base, dls=20.0), 2, [                           # behind, then
            (5.0, 2, _YIELD_NOW, True),                       # invalid
            (22.0, 2, _YIELD_NOW, False),
            (30.0, 2, _YIELD_NOW, True)]),
        (dict(base, dls=np.nan), 2, [(3.0, 2, _YIELD_NOW, True)]),
        (dict(base, dls=-0.0, speed=-0.0), 2, [               # d1 = 0: no
            (0.0, 2, _YIELD_NOW, True),                       # yield, then
            (10.0, 2, _YIELD_NOW, True)]),                    # -0.0 speed
        (dict(base, speed=np.nan), 2, [(3.0, 2, _YIELD_NOW, True)]),
    ]


def _cross_case(rng, B, V, LL, KC, fp, dt=1.0):
    """One seeded G4 case: B envs of V vehicles over LL lanelinks of KC
    crosses. The first len(_cp_crafts) vehicles of every env are crafted,
    each on its own row (foe_pos pointing into the row itself): no
    lanelink, the first failure at KC - 1, at 0 without blk_ok, no
    failure, the reach ties broken by ent, then dist, then pri both ways,
    t1 >, < and = t2 with dpos / cleared, crosses behind the vehicle and
    invalid ones, NaN and -0.0 in dls and speed. The rest are random:
    distances before and on the lanelink (some equal to a cross's), speeds
    from 0, parameters around a base vehicle, NaN and -0.0 sprinkled,
    G3's tables with every flag mixed and small ent / pri ranges (ties)."""
    t = np.float32 if fp == "f32" else np.float64
    E = LL * KC
    crafts = _cp_crafts(KC)
    nc = len(crafts)
    assert LL > nc and V > nc
    cd = np.sort(rng.uniform(0.0, 40.0, (LL, KC)), axis=1)
    cvalid = rng.random((LL, KC)) < 0.85
    cvalid[LL - 1] = False                      # a lanelink without crosses
    foetype = rng.integers(1, 4, (LL, KC)).astype(np.int32)
    foe_pos = rng.integers(0, E, (LL, KC)).astype(np.int32)
    ll_type = rng.integers(1, 4, LL).astype(np.int32)
    ll_is_turn = rng.random(LL) < 0.4
    own = {"exists": rng.random((B, E)) < 0.75,
           "yield": rng.random((B, E)) < 0.5,
           "cleared": rng.random((B, E)) < 0.35,
           "cyc": rng.random((B, E)) < 0.2,
           "dpos": rng.random((B, E)) < 0.5,
           "dist": rng.uniform(-10.0, 40.0, (B, E)),
           "reach": rng.integers(0, 8, (B, E)).astype(np.int32),
           "ent": rng.integers(0, 4, (B, E)).astype(np.int32),
           "pri": rng.integers(0, 6, (B, E)).astype(np.int32),
           "idx": rng.integers(-1, V, (B, E)).astype(np.int32)}
    the_ll = rng.integers(-1, LL, (B, V)).astype(np.int32)
    dls = rng.uniform(-25.0, 35.0, (B, V))
    on = the_ll >= 0
    eq = on & (rng.random((B, V)) < 0.05)       # dls at a cross's distance
    dls[eq] = cd[the_ll[eq], rng.integers(0, KC, int(eq.sum()))]
    speed = np.where(rng.random((B, V)) < 0.1, 0.0,
                     rng.uniform(0.0, 16.0, (B, V)))
    for a in (dls, speed):
        r = rng.random((B, V))
        a[r < 0.03] = np.nan
        a[(r >= 0.03) & (r < 0.06)] = -0.0
    params = rng.uniform(0.5, 10.0, (B, V, 12))
    params[..., list(_CP_COLS)] = np.array(_CP_BASE) * rng.uniform(
        0.7, 1.3, (B, V, len(_CP_COLS)))
    ent = rng.integers(0, 4, (B, V)).astype(np.int32)
    pri = rng.integers(0, 6, (B, V)).astype(np.int32)
    next_turn = rng.random((B, V)) < 0.4
    blk_ok = rng.random((B, V)) < 0.7
    for v, (veh, t1, crosses) in enumerate(crafts):
        r = v                                   # the vehicle's own row
        ll_type[r], ll_is_turn[r] = t1, False
        cvalid[r] = False
        foe_pos[r] = r * KC + np.arange(KC)
        for k, (d, t2, vals, valid) in enumerate(crosses[:KC]):
            cd[r, k], foetype[r, k], cvalid[r, k] = d, t2, valid
            own["exists"][:, r * KC + k] = False
            for key, x in vals.items():
                own[key][:, r * KC + k] = x
        # the rest of the row past the crafted crosses: distances beyond
        for k in range(len(crosses[:KC]), KC):
            cd[r, k] = 100.0 + k
        veh = dict(veh)
        the_ll[:, v] = veh.pop("the_ll", r)
        params[:, v, list(_CP_COLS)] = _CP_BASE
        if "maxspd" in veh:
            params[:, v, 8] = veh.pop("maxspd")
        for key, x in veh.items():
            {"speed": speed, "dls": dls, "ent": ent, "pri": pri,
             "blk_ok": blk_ok}[key][:, v] = x
        next_turn[:, v] = False
    own = {k: (a.astype(t) if a.dtype.kind == "f" else a).reshape(B, LL, KC)
           for k, a in own.items()}
    return dict(
        the_ll=the_ll, dls=dls.astype(t), speed=speed.astype(t),
        params=params.astype(t), ent=ent, pri=pri, next_turn=next_turn,
        blk_ok=blk_ok, own=own, net=dict(
            lnk_cross_d=cd.astype(t), lnk_cross_valid=cvalid,
            lnk_cross_foetype=foetype, lnk_cross_foe_pos=foe_pos,
            ll_type=ll_type, ll_is_turn=ll_is_turn,
            interval=np.array(dt, t)),
        ncraft=nc)


# name -> (B, V, LL, KC, float type, keywords of _cross_case)
CROSS_SPECS = {
    "B1_V37_KC5_f64": (1, 37, 24, 5, "f64", {}),
    "B3_V130_KC8_f32": (3, 130, 30, 8, "f32", {}),
    "B128_V256_KC6_f32": (128, 256, 24, 6, "f32", {}),
    "B130_V200_KC9_f64": (130, 200, 20, 9, "f64", dict(dt=0.5)),
    "B3_V64_KC1_f64": (3, 64, 20, 1, "f64", {}),
    "B128_V100_KC20_f64": (128, 100, 40, 20, "f64", {}),
    "B1_V1001_KC4_f32": (1, 1001, 64, 4, "f32", dict(dt=0.5)),
}
CROSS_CASES = tuple(CROSS_SPECS)


def cross_case(name, seed=0):
    """The G4 case `name` (one of CROSS_CASES), from its own seed."""
    B, V, LL, KC, fp, kw = CROSS_SPECS[name]
    return _cross_case(np.random.default_rng(
        [seed, 6000 + CROSS_CASES.index(name)]), B, V, LL, KC, fp, **kw)


def cross_cases(seed=0):
    """(name, case) for each of CROSS_CASES."""
    for name in CROSS_CASES:
        yield name, cross_case(name, seed)


def cross_args(case, device):
    """The case as cross_pass' arguments on `device`."""
    import torch
    T = lambda a: torch.as_tensor(a, device=device)
    return tuple(T(case[k]) for k in (
        "the_ll", "dls", "speed", "params", "ent", "pri", "next_turn",
        "blk_ok")) + ({k: T(v) for k, v in case["own"].items()},
                      {k: T(v) for k, v in case["net"].items()})


# ---- G15 shadow_insert -----------------------------------------------------

def _shadow_case(rng, B, V, MS, fp, offset=False, crowd=()):
    """One seeded G15 case: B envs of V slots, each env its own share of
    active slots and of changers among them (env 0 none where B > 1; a
    B = 1 case draws its own), every per-slot leaf random in its dtype
    (uids near INT32_MAX among them: 2^30 + uid wraps), seq_counter and
    overflow bits random. Env min(1, B - 1) has a changer in its last slot
    and a free slot at 0; the envs in `crowd` have more changers than MS
    and fewer free slots than changers (OV_SLOTS). Changers are active
    (the step's precondition)."""
    from cityflow_tpu_torch.core.state import SIM_BOOL, SIM_FLOAT, SLOT_FILL
    t = np.float32 if fp == "f32" else np.float64
    p_act = rng.uniform(0.3, 0.95, (B, 1))
    p_chg = rng.uniform(0.0, 0.2, (B, 1))
    if B > 1:
        p_chg[0] = 0.0
    active = rng.random((B, V)) < p_act
    do_change = active & (rng.random((B, V)) < p_chg)
    e = min(1, B - 1)
    active[e, 0], do_change[e, 0] = False, False
    active[e, V - 1] = do_change[e, V - 1] = True
    for c in crowd:
        active[c] = True
        active[c, rng.choice(V, max(1, MS // 3), replace=False)] = False
        do_change[c] = active[c] & (rng.random(V) < 0.5)
    leaves = {}
    for k in SLOT_FILL:
        shape = (B, V, 12) if k == "params" else (B, V)
        if k in SIM_BOOL:
            leaves[k] = rng.random(shape) < 0.5
        elif k in SIM_FLOAT:
            leaves[k] = rng.uniform(-50.0, 300.0, shape).astype(t)
        else:
            leaves[k] = rng.integers(-5, 2000, shape).astype(np.int32)
    leaves["active"] = active
    uid = rng.integers(0, 10 ** 6, (B, V)).astype(np.int32)
    big = rng.random((B, V)) < 0.05
    uid[big] = rng.choice(np.int32([2 ** 31 - 1, 2 ** 30 - 1, 2 ** 30]),
                          int(big.sum()))
    leaves["uid"] = np.where(active, uid, -1).astype(np.int32)
    return dict(
        leaves=leaves, do_change=do_change,
        target=rng.integers(0, 60, (B, V)).astype(np.int32),
        seq_counter=rng.integers(0, 2 ** 31 - 2, B).astype(np.int32),
        overflow=rng.choice(np.int32([0, 0, 2, 4, 8, 1]), B),
        MS=MS, offset=offset)


# name -> (B, V, MS, float type, keywords of _shadow_case)
SHADOW_SPECS = {
    "B1_V37_MS4_f64": (1, 37, 4, "f64", {}),
    "B1_V64_MS1_f32": (1, 64, 1, "f32", {}),
    "B1_V512_MS16_f64_crowd": (1, 512, 16, "f64", dict(crowd=(0,))),
    "B3_V130_MS8_f32": (3, 130, 8, "f32", dict(crowd=(2,))),
    "B3_V9000_MS64_f64": (3, 9000, 64, "f64", {}),
    "B1_V20000_MS200_f32": (1, 20000, 200, "f32", {}),
    "B128_V512_MS16_f32": (128, 512, 16, "f32", dict(crowd=(5, 127))),
    "B130_V256_MS8_f64": (130, 256, 8, "f64", dict(crowd=(129,))),
    "B3_V64_MS4_f32_offset": (3, 64, 4, "f32", dict(offset=True)),
}
SHADOW_CASES = tuple(SHADOW_SPECS)


def shadow_case(name, seed=0):
    """The G15 case `name` (one of SHADOW_CASES), from its own seed."""
    B, V, MS, fp, kw = SHADOW_SPECS[name]
    return _shadow_case(np.random.default_rng(
        [seed, 7000 + SHADOW_CASES.index(name)]), B, V, MS, fp, **kw)


def shadow_cases(seed=0):
    """(name, case) for each of SHADOW_CASES."""
    for name in SHADOW_CASES:
        yield name, shadow_case(name, seed)


def shadow_args(case, device):
    """The case as shadow_insert's arguments on `device`, fresh tensors on
    every call (G15 writes them in place): (st, st2, do_change, target,
    MS) with st2 = st and the plan's fields replaced, lc_target being
    `target` itself, as plan_lane_change passes them; with `offset` every
    tensor a view one element into a larger buffer."""
    import torch
    from cityflow_tpu_torch.core.state import SIM_FIELDS, SimState
    T = lambda a: _tensor(np.array(a), device, case["offset"])  # copies
    lv = case["leaves"]
    B = case["do_change"].shape[0]
    f = lv["dis"].dtype
    small = {"phase": np.zeros((B, 1), np.int32),
             "phase_remain": np.zeros((B, 1), f),
             "last_of_drv": np.full((B, 1), -1, np.int32),
             "hist_ring_num": np.zeros((B, 1, 1), f),
             "hist_ring_ssum": np.zeros((B, 1, 1), f),
             "hist_num": np.zeros((B, 1), f), "hist_ssum": np.zeros((B, 1), f),
             "cum_travel": np.zeros(B, f)}
    vals = {k: lv[k] if k in lv else small.get(k, np.zeros(B, np.int32))
            for k in SIM_FIELDS}
    vals["seq_counter"], vals["overflow"] = case["seq_counter"], \
        case["overflow"]
    st = SimState(**{k: T(v) for k, v in vals.items()})
    target = T(case["target"])
    st2 = st.replace_fields(lc_target=target, lc_changing=T(
        lv["lc_changing"] | case["do_change"]), lc_lgap=T(lv["lc_lgap"]))
    return st, st2, T(case["do_change"]), target, case["MS"]


# ---- L4 lc_partner ---------------------------------------------------------

# uids near INT32_MAX that float32 cannot tell apart (f32 rounds each to
# 2^31): the int32 compare must
_BIG_UIDS = np.int32([2 ** 31 - 1, 2 ** 31 - 2, 2 ** 31 - 3])


def _road_tables(rng, N):
    """(inner_src, outer_src) of N lane columns cut into roads of 1-4
    lanes: inner = the column before in the road, outer = the one after,
    -1 at a road's edges (a one-lane road has neither)."""
    inner = np.full(N, -1, np.int32)
    outer = np.full(N, -1, np.int32)
    first = 0
    while first < N:
        n = min(int(rng.integers(1, 5)), N - first)
        for i in range(n):
            if i > 0:
                inner[first + i] = first + i - 1
            if i < n - 1:
                outer[first + i] = first + i + 1
        first += n
    return inner, outer


def _partner_case(rng, B, S, N, C):
    """One seeded L4 case: B envs of N lane columns of S slots. uids from a
    few values (so that rows find same-uid rows with either shadow flag
    before, at and after their partner, occupied or stale past n_l) and
    from _BIG_UIDS; sh, chg and dir (-1 / 0 / +1, also toward a side the
    lane lacks) random on every row, occupied or not; n_l from 0 to S; C
    float32 channels with NaN and -0.0. Env 0 lane 0 is crafted where S
    allows: its partners at the outer column's slot 0 and at the inner
    column's n_l - 1 behind a same-uid, same-flag row; a row whose partner
    uid differs by one near INT32_MAX behind one that matches; a stale
    match past n_l; a match on a row that is not paired (dir 0)."""
    inner, outer = _road_tables(rng, N)
    inner[0], outer[0] = -1, -1
    if N >= 3:                         # lane 1 between lanes 0 and 2
        inner[:3], outer[:3] = (-1, 0, 1), (1, 2, -1)
    shape = (S, N, B)
    uid = rng.integers(0, 6, shape).astype(np.int32)
    big = rng.random(shape) < 0.05
    uid[big] = rng.choice(_BIG_UIDS, int(big.sum()))
    sh = rng.random(shape) < 0.35
    chg = rng.random(shape) < 0.4
    l_dir = rng.choice(np.int32([-1, 0, 1]), shape, p=[0.4, 0.2, 0.4])
    n_l = rng.integers(0, S + 1, (N, B)).astype(np.int32)
    n_l[rng.random((N, B)) < 0.1] = S
    chans = []
    for _ in range(C):
        x = rng.uniform(-50.0, 300.0, shape).astype(np.float32)
        r = rng.random(shape)
        x[r < 0.03] = np.nan
        x[(r >= 0.03) & (r < 0.06)] = -0.0
        chans.append(x)
    if N >= 3 and S >= 6:
        # lane 1 of env 0 looks at lanes 0 (inner) and 2 (outer)
        n_l[:3, 0] = (4, S, 3)
        rows = [  # (slot, uid, sh, chg, dir) of lane 1
            (0, 101, False, True, 1),    # outer partner at slot 0
            (1, 102, True, True, 1),     # shadow: inner partner at 3 = n-1
            (2, 103, False, True, 0),    # not paired (dir 0): still fetched
            (3, 104, True, True, 1),     # inner: 104 only past n_l
            (4, 2 ** 31 - 2, False, True, 1)]  # outer: 2^31 - 1 first
        for s, u, f, c, d in rows:
            uid[s, 1, 0], sh[s, 1, 0], chg[s, 1, 0], l_dir[s, 1, 0] = \
                u, f, c, d
        uid[:, 0, 0], uid[:, 2, 0] = 7, 7      # no stray matches
        uid[0, 2, 0], sh[0, 2, 0] = 101, True
        uid[0, 0, 0], sh[0, 0, 0] = 102, True  # same flag: not it
        uid[3, 0, 0], sh[3, 0, 0] = 102, False
        uid[1, 0, 0], sh[1, 0, 0] = 103, True
        uid[4, 0, 0], sh[4, 0, 0] = 104, False  # past n_l = 4
        uid[1, 2, 0], sh[1, 2, 0] = 2 ** 31 - 1, True
        uid[2, 2, 0], sh[2, 2, 0] = 2 ** 31 - 2, True
    return dict(uid=uid, sh=sh, l_dir=l_dir, n_l=n_l, chg=chg, chans=chans,
                inner_src=inner, outer_src=outer)


# name -> (B, S, N, C): S = 300 at B = 128 needs more than 48 KB of staging
# (the kernel opts in), S = 800 more than a block's 227 KB at 32 envs (the
# kernel narrows its env tile)
PARTNER_SPECS = {
    "B1_S40_C1": (1, 40, 24, 1),
    "B3_S12_C2": (3, 12, 30, 2),
    "B128_S40_C2": (128, 40, 16, 2),
    "B130_S7_C3": (130, 7, 20, 3),
    "B1_S1_C4": (1, 1, 9, 4),
    "B3_S33_C4": (3, 33, 12, 4),
    "B128_S300_C1": (128, 300, 4, 1),
    "B40_S800_C2": (40, 800, 3, 2),
}
PARTNER_CASES = tuple(PARTNER_SPECS)


def partner_case(name, seed=0):
    """The L4 case `name` (one of PARTNER_CASES), from its own seed."""
    B, S, N, C = PARTNER_SPECS[name]
    return _partner_case(np.random.default_rng(
        [seed, 8000 + PARTNER_CASES.index(name)]), B, S, N, C)


def partner_cases(seed=0):
    """(name, case) for each of PARTNER_CASES."""
    for name in PARTNER_CASES:
        yield name, partner_case(name, seed)


def partner_args(case, device):
    """The case as lc_partner's arguments on `device`; the gather mode
    takes the match it returns and the same channels."""
    import torch
    T = lambda a: torch.as_tensor(a, device=device)
    return (T(case["uid"]), T(case["sh"]), T(case["l_dir"]), T(case["n_l"]),
            T(case["chg"]), [T(c) for c in case["chans"]],
            {k: T(case[k]) for k in ("inner_src", "outer_src")})


# ---- G3 notify_cross -------------------------------------------------------

# a base vehicle's params: len 5, maxNegAcc 4.5, usualPosAcc 2.5,
# maxSpeed 16, yieldDistance 5, turnSpeed 8 (the columns G3 reads), the
# others as the reference's defaults
_NC_PRM = (11.11, 5.0, 2.0, 2.0, 4.5, 2.5, 4.5, 2.5, 16.0, 1.5, 5.0, 8.0)


def _nc_leaves(rng, B, V, L, LL, t):
    """Random slot leaves around the base vehicle: dis from -5 to 60 with
    NaN and -0.0, speeds from 0, params jittered, cyc, prev_drv naming
    some drivable, enter_ll_time and priority 0 to 4."""
    dis = rng.uniform(-5.0, 60.0, (B, V))
    r = rng.random((B, V))
    dis[r < 0.03] = np.nan
    dis[(r >= 0.03) & (r < 0.06)] = -0.0
    return dict(
        dis=dis.astype(t),
        speed=np.where(rng.random((B, V)) < 0.2, 0.0,
                       rng.uniform(0.0, 16.0, (B, V))).astype(t),
        params=(np.array(_NC_PRM) * rng.uniform(0.6, 1.4, (B, V, 12))
                ).astype(t),
        cyc=rng.random((B, V)) < 0.3,
        prev_drv=rng.integers(-1, L + LL, (B, V)).astype(np.int32),
        enter_ll_time=rng.integers(0, 5, (B, V)).astype(np.int32),
        priority=rng.integers(0, 5, (B, V)).astype(np.int32))


def _notify_case(rng, B, V, L, LL, KC, K, fp, over=False, dt=1.0):
    """One seeded G3 case: B envs of V slots over L lanes and LL
    lanelinks of KC crosses, k_link = K. Random: each link's end and start
    lanes and length, its cross distances (sorted, some equal to a
    candidate's tail), the end lanes' rear and start lanes' front slots
    (-1 too), whose prev_drv names the link or not, whose next drivable
    is the link or not, ll_avail, each drivable's count in G1's order
    (sorted_idx a permutation of the slots, drv_off its offsets; a link
    holds 0 to K vehicles, with `over` up to K + 3, of which G3 reads the
    first K), the leaves with NaN and -0.0 in dis, ties in front
    position. Crafted, in every env: link 0 has no candidate (e_ok fails
    by prev_drv, s_ok by veh_next), link 1's start vehicle fails s_ok by
    ll_avail alone, link 2's first two vehicles tie in front position,
    link 3's crosses sit at candidate 0's tail (tail < d fails) and at
    its first vehicle's tail (tail <= d holds), link 4's vehicles have NaN
    and -0.0 dis."""
    t = np.float32 if fp == "f32" else np.float64
    D = L + LL
    drv_len = np.concatenate([rng.uniform(20.0, 300.0, L),
                              rng.uniform(5.0, 30.0, LL)]).astype(t)
    ll_end = rng.integers(0, L, LL).astype(np.int32)
    ll_start = rng.integers(0, L, LL).astype(np.int32)
    ll_is_turn = rng.random(LL) < 0.4
    cd = np.sort(rng.uniform(-2.0, 30.0, (LL, KC)), axis=1)
    lv = _nc_leaves(rng, B, V, L, LL, t)
    last_of = rng.integers(-1, V, (B, D)).astype(np.int32)
    first_of = rng.integers(-1, V, (B, D)).astype(np.int32)
    veh_next = rng.integers(-1, D, (B, V)).astype(np.int32)
    ll_avail = rng.random((B, LL)) < 0.7
    # a rear vehicle still on its link half of the time, a front vehicle
    # whose next drivable is the link half of the time
    for l in range(LL):
        s = last_of[:, ll_end[l]]
        on = (s >= 0) & (rng.random(B) < 0.5)
        lv["prev_drv"][on, s[on]] = L + l
        s = first_of[:, ll_start[l]]
        on = (s >= 0) & (rng.random(B) < 0.5)
        veh_next[on, s[on]] = L + l
    # per-drivable counts: lanes 0 to 2, links 0 to K (K + 3 with `over`)
    cnt = np.zeros((B, D), np.int64)
    cnt[:, :L] = rng.integers(0, 3, (B, L))
    cnt[:, L:] = rng.integers(0, K + (4 if over else 1), (B, LL))
    crafted = LL >= 5 and L >= 10 and V >= 18
    if crafted:
        cnt[:, L] = 0                             # link 0: no vehicle
        cnt[:, L + 1:L + 5] = min(2, K)
    for b in range(B):                            # fit the pool: cut lanes,
        while cnt[b].sum() > V:                   # then the last links
            d = np.nonzero(cnt[b])[0][0 if cnt[b, :L].any() else -1]
            cnt[b, d] -= 1
    drv_off = np.concatenate([np.zeros((B, 1), np.int64),
                              np.cumsum(cnt, 1)], 1).astype(np.int32)
    sorted_idx = np.stack([rng.permutation(V) for _ in range(B)]
                          ).astype(np.int32)
    eb = np.arange(B)
    slot = lambda j: (eb + j) % V
    if crafted:
        # links 1-4's vehicles are slots (b + 10 ...) % V, apart from the
        # crafted end and start vehicles (b + 0 ... 9) % V
        for j in range(1, 5):
            for r in range(min(2, K)):
                s = slot(10 + 2 * (j - 1) + r)
                for b in range(B):
                    pos = drv_off[b, L + j] + r
                    here = int(np.nonzero(sorted_idx[b] == s[b])[0][0])
                    sorted_idx[b, [pos, here]] = sorted_idx[b, [here, pos]]
    # ties with the link's vehicle before, in dis and len
    for b in range(B):
        for l in range(LL):
            lo, n = drv_off[b, L + l], min(cnt[b, L + l], K)
            for r in range(1, n):
                if rng.random() < 0.1:
                    u, w = sorted_idx[b, lo + r - 1], sorted_idx[b, lo + r]
                    lv["dis"][b, w] = lv["dis"][b, u]
    # some crosses exactly at a link's first vehicle's tail in env 0
    first0 = sorted_idx[0, np.minimum(drv_off[0, L:L + LL], V - 1)]
    tail0 = lv["dis"][0, first0] - lv["params"][0, first0, 1]
    pick = (rng.random((LL, KC)) < 0.1) & (cnt[0, L:, None] > 0) & (K > 0)
    cd = np.where(pick & ~np.isnan(tail0)[:, None], tail0[:, None], cd)
    if crafted:
        ll_end[:5], ll_start[:5] = np.arange(5), np.arange(5, 10)
        for j in range(5):
            last_of[:, j], first_of[:, 5 + j] = slot(j), slot(5 + j)
            lv["prev_drv"][eb, slot(j)] = L + j  # on its link: e_ok
            veh_next[eb, slot(5 + j)] = L + j    # entering it
        lv["prev_drv"][eb, slot(0)] = L + 7      # link 0: e_ok fails by
        veh_next[eb, slot(5)] = L + 7            # prev, s_ok by next
        ll_avail[:, 0] = True
        ll_avail[:, 1] = False                   # link 1: s_ok by avail
        row = lambda j, r: slot(10 + 2 * (j - 1) + r)
        for r in range(min(2, K)):               # link 2: a tie at 12
            lv["dis"][eb, row(2, r)] = 12.0
            lv["params"][eb, row(2, r), 1] = 4.0
        lv["dis"][eb, row(3, 0)] = 9.0           # link 3: tail 5
        lv["params"][eb, row(3, 0), 1] = 4.0
        if K > 1:
            lv["dis"][eb, row(4, 0)] = np.nan
            lv["dis"][eb, row(4, 1)] = -0.0
        # link 3's crosses: at candidate 0's tail (ll_len + dis - len,
        # strict: not eligible) and at its first vehicle's tail (eligible)
        lv["dis"][eb, slot(3)] = -3.0
        lv["params"][eb, slot(3), 1] = 4.0
        cd[3, 0] = (drv_len[L + 3] + t(-3.0)) - t(4.0)
        if KC > 1:
            cd[3, 1] = 5.0
    return dict(
        net=dict(lnk_cross_d=cd.astype(t), drv_len=drv_len, ll_end=ll_end,
                 ll_start=ll_start, ll_is_turn=ll_is_turn,
                 cross_ll=np.zeros((1, 2), np.int32),
                 interval=np.array(dt, t)),
        arr=dict(last_of=last_of, first_of=first_of, sorted_idx=sorted_idx,
                 drv_off=drv_off),
        veh_next=veh_next, ll_avail=ll_avail, leaves=lv, L=L, k_link=K)


# name -> (B, V, L, LL, KC, K, float type, keywords of _notify_case)
NOTIFY_SPECS = {
    "B1_KC20_K16_f64": (1, 64, 12, 24, 20, 16, "f64", {}),
    "B3_KC5_K8_f32": (3, 50, 10, 16, 5, 8, "f32", {}),
    "B128_KC6_K4_f32": (128, 40, 10, 12, 6, 4, "f32", {}),
    "B130_KC3_K1_f64": (130, 20, 10, 8, 3, 1, "f64", dict(dt=0.5)),
    "B3_KC1_K40_f64": (3, 80, 10, 10, 1, 40, "f64", {}),
    "B1_KC9_K2_f32_over": (1, 30, 12, 20, 9, 2, "f32", dict(over=True)),
    "B3_KC20_K8_f64_over": (3, 60, 10, 14, 20, 8, "f64", dict(over=True)),
    # k_link so large that a block holds 2 groups (16 threads) or 1 (8):
    # the crosses of a link take more rounds of the part-warp
    "B3_KC20_K128_f64": (3, 200, 10, 10, 20, 128, "f64", {}),
    "B1_KC20_K240_f64": (1, 300, 10, 6, 20, 240, "f64", {}),
    "B3_KC20_K218_f32": (3, 250, 10, 8, 20, 218, "f32", {}),
}
NOTIFY_CASES = tuple(NOTIFY_SPECS)


def notify_case(name, seed=0):
    """The G3 case `name` (one of NOTIFY_CASES), from its own seed."""
    B, V, L, LL, KC, K, fp, kw = NOTIFY_SPECS[name]
    return _notify_case(np.random.default_rng(
        [seed, 9000 + NOTIFY_CASES.index(name)]), B, V, L, LL, KC, K, fp,
        **kw)


def notify_cases(seed=0):
    """(name, case) for each of NOTIFY_CASES."""
    for name in NOTIFY_CASES:
        yield name, notify_case(name, seed)


def notify_args(case, device):
    """The case as notify_cross' arguments on `device`."""
    import torch
    T = lambda a: torch.as_tensor(a, device=device)
    return ({k: T(v) for k, v in case["net"].items()},
            {k: T(v) for k, v in case["arr"].items()}, T(case["veh_next"]),
            T(case["ll_avail"]), {k: T(v) for k, v in case["leaves"].items()},
            case["L"], case["k_link"])


# ---- G1 arrange ------------------------------------------------------------

_AR_DIS = (0.0, -0.0, 2.5, 7.0, 7.0, np.nan, 12.25, 30.0, -np.nan, 55.5)


def _arrange_case(rng, B, V, L, LL, K, fp, p_run=0.8, long_lane=0,
                  idle_env=False, exact_k=False):
    """One seeded G1 case: B envs of V slots over L lanes and LL
    lanelinks, k_link = K. Random: running flags, drivables, dis from a
    small set (ties, -0.0 against +0.0, NaN of both signs), list_seq from
    a small range (ties), so that every key term decides somewhere.
    `long_lane` running vehicles of env 0 on lane 0 (a bucket longer than
    a block's 256 positions or a warp), `idle_env`: the last env runs
    nothing, `exact_k`: in env 0 lanelink 0 holds exactly K vehicles and
    lanelink 1 K + 1 (overflow), every other lanelink at most K."""
    t = np.float32 if fp == "f32" else np.float64
    D = L + LL
    running = rng.random((B, V)) < p_run
    drv = rng.integers(0, D, (B, V)).astype(np.int32)
    dis = rng.choice(np.array(_AR_DIS), (B, V)).astype(t)
    wild = rng.random((B, V)) < 0.5
    dis[wild] = rng.uniform(0.0, 60.0, int(wild.sum())).astype(t)
    list_seq = rng.integers(0, 6, (B, V)).astype(np.int32)
    if long_lane:
        running[0, :long_lane] = True
        drv[0, :long_lane] = 0
    if exact_k:
        # at most K vehicles on a lanelink (the extras to lanes), then in
        # env 0 exactly K on lanelink 0 and K + 1 on lanelink 1
        for b in range(B):
            for l in range(LL):
                on = np.nonzero(running[b] & (drv[b] == L + l))[0][K:]
                drv[b, on] = rng.integers(0, L, on.size)
        on = running[0] & ((drv[0] == L) | (drv[0] == L + 1))
        drv[0, on] = rng.integers(0, L, int(on.sum()))
        lane = np.nonzero(running[0] & (drv[0] < L))[0]
        pick = rng.choice(lane, 2 * K + 1, replace=False)
        drv[0, pick[:K]] = L
        drv[0, pick[K:]] = L + 1
    if idle_env:
        running[-1] = False
    return dict(running=running, drv=drv, dis=dis, list_seq=list_seq, D=D,
                L=L, k_link=K)


# name -> (B, V, L, LL, K, float type, keywords of _arrange_case)
ARRANGE_SPECS = {
    "B1_V64_f64": (1, 64, 6, 10, 4, "f64", {}),
    "B3_V1000_f32": (3, 1000, 12, 30, 3, "f32", {}),
    "B128_V200_f32": (128, 200, 10, 20, 2, "f32", {}),
    "B130_V97_f64": (130, 97, 8, 12, 16, "f64", dict(idle_env=True)),
    "B1_V3000_f64_long": (1, 3000, 4, 4, 4, "f64",
                          dict(long_lane=700, p_run=0.3)),
    "B3_V1030_f32_long": (3, 1030, 5, 9, 2, "f32",
                          dict(long_lane=300, p_run=0.5)),
    "B3_V500_f64_exactk": (3, 500, 10, 8, 5, "f64", dict(exact_k=True)),
    "B1_V777_f32_exactk": (1, 777, 20, 6, 16, "f32", dict(exact_k=True)),
    "B3_V300_f64_idle": (3, 300, 10, 40, 4, "f64",
                         dict(idle_env=True, p_run=0.2)),
    "B1_V5000_f32_wide": (1, 5000, 3000, 6000, 16, "f32", {}),
}
ARRANGE_CASES = tuple(ARRANGE_SPECS)


def arrange_case(name, seed=0):
    """The G1 case `name` (one of ARRANGE_CASES), from its own seed."""
    B, V, L, LL, K, fp, kw = ARRANGE_SPECS[name]
    return _arrange_case(np.random.default_rng(
        [seed, 9500 + ARRANGE_CASES.index(name)]), B, V, L, LL, K, fp, **kw)


def arrange_cases(seed=0):
    """(name, case) for each of ARRANGE_CASES."""
    for name in ARRANGE_CASES:
        yield name, arrange_case(name, seed)


def arrange_args(case, device):
    """The case as arrange's arguments on `device`."""
    import torch
    T = lambda a: torch.as_tensor(a, device=device)
    return (T(case["running"]), T(case["drv"]), T(case["dis"]),
            T(case["list_seq"]), case["D"], case["L"], case["k_link"])


# ---- G7 lc_plan, yield mode ------------------------------------------------

def _yield_case(rng, B, V, fp, p_recv=0.3, every=False, none=False):
    """One seeded G7 yield case: B envs of V slots. Random: each slot's
    lc_recv (a sender slot, or -1), the senders' lc_tleader (some the
    receiver itself), lc_tfollower (-1 too), lc_fgap (some small, so that
    the cap goes negative and becomes 100), speeds from 0 and params.
    `every`: every slot receives, `none`: no slot does. An odd V starts
    the rows after the first off a 16-byte word (the kernel's narrow
    path); V not a multiple of 4 leaves a part word at each row's end."""
    t = np.float32 if fp == "f32" else np.float64
    recv = np.where(rng.random((B, V)) < p_recv,
                    rng.integers(0, V, (B, V)), -1).astype(np.int32)
    if every:
        recv = rng.integers(0, V, (B, V)).astype(np.int32)
    if none:
        recv[:] = -1
    tleader = rng.integers(-1, V, (B, V)).astype(np.int32)
    # a sender whose target leader is its receiver: no cap
    lead = rng.random((B, V)) < 0.2
    for b, v in zip(*np.nonzero(lead & (recv >= 0))):
        tleader[b, recv[b, v]] = v
    return dict(
        lc_recv=recv, lc_tleader=tleader,
        lc_tfollower=np.where(rng.random((B, V)) < 0.4, -1,
                              rng.integers(0, V, (B, V))).astype(np.int32),
        lc_fgap=np.where(rng.random((B, V)) < 0.3,
                         rng.uniform(-5.0, 1.0, (B, V)),
                         rng.uniform(0.0, 80.0, (B, V))).astype(t),
        speed=np.where(rng.random((B, V)) < 0.2, 0.0,
                       rng.uniform(0.0, 16.0, (B, V))).astype(t),
        params=(np.array(_NC_PRM) * rng.uniform(0.6, 1.4, (B, V, 12))
                ).astype(t),
        interval=np.array(1.0, t))


# name -> (B, V, float type, keywords of _yield_case)
YIELD_SPECS = {
    "B1_V64_f64": (1, 64, "f64", {}),
    "B3_V257_f32_offset": (3, 257, "f32", {}),
    "B128_V128_f32": (128, 128, "f32", {}),
    "B130_V40_f64_every": (130, 40, "f64", dict(every=True)),
    "B3_V100_f64_none": (3, 100, "f64", dict(none=True)),
    "B1_V999_f32_every": (1, 999, "f32", dict(every=True)),
}
YIELD_CASES = tuple(YIELD_SPECS)


def yield_case(name, seed=0):
    """The G7 yield case `name` (one of YIELD_CASES), from its own seed."""
    B, V, fp, kw = YIELD_SPECS[name]
    return _yield_case(np.random.default_rng(
        [seed, 9700 + YIELD_CASES.index(name)]), B, V, fp, **kw)


def yield_cases(seed=0):
    """(name, case) for each of YIELD_CASES."""
    for name in YIELD_CASES:
        yield name, yield_case(name, seed)


def yield_args(case, device):
    """The case as (st, net) for lc_plan("yield", st, net, L): a state
    that holds the leaves the yield mode reads (the others are zeros of
    their shapes) and the tables it is given."""
    import torch
    from cityflow_tpu_torch.core.state import SimState
    T = lambda a: torch.as_tensor(a, device=device)
    B, V = case["lc_recv"].shape
    f = T(case["speed"]).dtype
    z = lambda dt: torch.zeros((B, V), dtype=dt, device=device)
    st = SimState(**{k: None for k in SimState.__dataclass_fields__})
    st = st.replace_fields(
        running=z(torch.bool), is_shadow=z(torch.bool),
        lc_changing=z(torch.bool), lc_last_t=z(f), drv=z(torch.int32),
        dis=z(f), speed=T(case["speed"]), gap=z(f),
        params=T(case["params"]), route=z(torch.int32),
        route_pos=z(torch.int32), lc_target=z(torch.int32),
        priority=z(torch.int32),
        step=torch.zeros(B, dtype=torch.int32, device=device),
        lc_recv=T(case["lc_recv"]), lc_fgap=T(case["lc_fgap"]),
        lc_tleader=T(case["lc_tleader"]),
        lc_tfollower=T(case["lc_tfollower"]))
    i1 = lambda n: torch.zeros(n, dtype=torch.int32, device=device)
    net = dict(drv_len=torch.ones(2, dtype=f, device=device),
               lane_out=torch.full((1, 1), -1, dtype=torch.int32,
                                   device=device),
               lane_local=i1(1), ll_end=i1(1), route_len=i1(1),
               route_next_ll=torch.full((1, 1, 1), -1, dtype=torch.int32,
                                        device=device),
               interval=T(case["interval"]))
    return st, net


# ---- G11 spawn_slots -------------------------------------------------------

_SP_NF = 5
_SP_STEPS = 12


def _slot_leaves(rng, B, V, t):
    """Every per-slot leaf of B envs of V slots, random in its dtype."""
    from cityflow_tpu_torch.core.state import SIM_BOOL, SIM_FLOAT, SLOT_FILL
    leaves = {}
    for k in SLOT_FILL:
        shape = (B, V, 12) if k == "params" else (B, V)
        if k in SIM_BOOL:
            leaves[k] = rng.random(shape) < 0.5
        elif k in SIM_FLOAT:
            leaves[k] = rng.uniform(-50.0, 300.0, shape).astype(t)
        else:
            leaves[k] = rng.integers(-5, 2000, shape).astype(np.int32)
    return leaves


def _spawn_case(rng, B, V, MS, fp, offset=False, full=(), few=(), end=(),
                none=(), late=()):
    """One seeded G11 case: a spawn table of _SP_STEPS steps in order, each
    with 0 to MS + 3 rows (a step may hold more rows than one window), then
    MS rows of step -1 (spawn_table's padding; 2 where `end` names an env,
    so that a window reaches past the table's end); B envs, each at a step
    that has rows with its cursor at that step's first row, every
    per-slot leaf random in its dtype, its own share of free slots and
    overflow bits. The envs in `full` have no free slot (OV_SLOTS), those
    in `few` fewer free slots than due rows, those in `end` the last step
    and a cursor past n - MS (the window clamped to the table's end, uid
    from the cursor itself), those in `none` a step without rows (nothing
    due), those in `late` their first 80% of slots taken (the scan walks
    several tiles)."""
    t = np.float32 if fp == "f32" else np.float64
    counts = rng.integers(0, MS + 4, _SP_STEPS)
    counts[[0, _SP_STEPS - 1]] = [0, max(1, counts[-1])]
    counts[1] = max(counts[1], MS // 3 + 2)
    steps = np.repeat(np.arange(_SP_STEPS), counts).astype(np.int32)
    pad = 2 if end else MS
    n = steps.size + pad
    tbl = dict(
        step=np.concatenate([steps, np.full(pad, -1, np.int32)]),
        flow=rng.integers(0, _SP_NF, n).astype(np.int32),
        priority=rng.choice(np.int32([0, 7, 2 ** 31 - 1, -5, 123456]), n),
        first_drv=rng.integers(0, 500, n).astype(np.int32),
        route=rng.integers(0, 300, n).astype(np.int32))
    first = np.concatenate([[0], np.cumsum(counts)])
    has = np.nonzero(counts)[0]
    step = rng.choice(has, B).astype(np.int32)
    cursor = first[step].astype(np.int32)
    leaves = _slot_leaves(rng, B, V, t)
    active = rng.random((B, V)) < rng.uniform(0.2, 0.9, (B, 1))
    for b in full:
        active[b] = True
    for b in few:
        step[b], cursor[b] = 1, first[1]
        active[b] = True
        active[b, rng.choice(V, max(1, MS // 3), replace=False)] = False
    for b in end:
        step[b], cursor[b] = _SP_STEPS - 1, n - 1
    for b in none:
        step[b], cursor[b] = 0, first[0]
    for b in late:
        active[b, :int(0.8 * V)] = True
    leaves["active"] = active
    return dict(leaves=leaves, step=step, cursor=cursor, tbl=tbl,
                overflow=rng.choice(np.int32([0, 0, 2, 4, 8, 1]), B),
                flow_params=rng.uniform(0.5, 30.0, (_SP_NF, 12)).astype(t),
                interval=t(0.5), MS=MS, offset=offset)


# name -> (B, V, MS, float type, keywords of _spawn_case)
SPAWN_SPECS = {
    "B1_V16_MS4_f64": (1, 16, 4, "f64", {}),
    "B3_V64_MS8_f32_mixed": (3, 64, 8, "f32", dict(few=(1,), none=(2,))),
    "B2_V32_MS8_f64_full": (2, 32, 8, "f64", dict(full=(0,), few=(1,))),
    "B3_V48_MS6_f32_end": (3, 48, 6, "f32", dict(end=(0, 2))),
    "B2_V40_MS4_f64_none": (2, 40, 4, "f64", dict(none=(0, 1))),
    "B3_V100_MS5_f32": (3, 100, 5, "f32", dict(late=(1,))),
    "B4_V9000_MS64_f32_late": (4, 9000, 64, "f32",
                               dict(late=(0, 3), few=(2,))),
    "B128_V512_MS16_f32": (128, 512, 16, "f32",
                           dict(full=(5,), few=(6,), none=(7,), end=(127,))),
    "B130_V256_MS8_f64": (130, 256, 8, "f64", dict(late=(129,))),
    "B3_V64_MS1_f32_offset": (3, 64, 1, "f32", dict(offset=True, few=(0,))),
}
SPAWN_CASES = tuple(SPAWN_SPECS)
# the cases of both forms: the copying form refuses views one element in
# (spawn_slots.row_words_aligned), the in-place form takes every case
SPAWN_COPY_CASES = tuple(n for n in SPAWN_CASES
                         if not SPAWN_SPECS[n][4].get("offset"))


def spawn_case(name, seed=0):
    """The G11 case `name` (one of SPAWN_CASES), from its own seed."""
    B, V, MS, fp, kw = SPAWN_SPECS[name]
    return _spawn_case(np.random.default_rng(
        [seed, 10000 + SPAWN_CASES.index(name)]), B, V, MS, fp, **kw)


def spawn_cases(seed=0):
    """(name, case) for each of SPAWN_CASES."""
    for name in SPAWN_CASES:
        yield name, spawn_case(name, seed)


def _sim_state(leaves, B, f, T, **scalars):
    """A SimState of B envs from the per-slot `leaves` and the per-env
    `scalars` (numpy), the other fields one wide, each through T."""
    from cityflow_tpu_torch.core.state import SIM_FIELDS, SimState
    small = {"phase": np.zeros((B, 1), np.int32),
             "phase_remain": np.zeros((B, 1), f),
             "last_of_drv": np.full((B, 1), -1, np.int32),
             "hist_ring_num": np.zeros((B, 1, 1), f),
             "hist_ring_ssum": np.zeros((B, 1, 1), f),
             "hist_num": np.zeros((B, 1), f), "hist_ssum": np.zeros((B, 1), f),
             "cum_travel": np.zeros(B, f), **scalars}
    return SimState(**{k: T(leaves[k] if k in leaves
                            else small.get(k, np.zeros(B, np.int32)))
                       for k in SIM_FIELDS})


def spawn_args(case, device):
    """The case as spawn_slots' arguments on `device` (st, spawn_tbl,
    flow_params, interval, MS), fresh tensors on every call (the in-place
    form writes them); with `offset` every tensor a view one element into
    a larger buffer."""
    T = lambda a: _tensor(np.array(a), device, case["offset"])  # copies
    lv = case["leaves"]
    B = case["step"].shape[0]
    f = lv["dis"].dtype
    st = _sim_state(lv, B, f, T, step=case["step"],
                    spawn_cursor=case["cursor"], overflow=case["overflow"])
    import torch
    return (st, {k: T(v) for k, v in case["tbl"].items()},
            T(case["flow_params"]),
            torch.tensor(case["interval"], device=device), case["MS"])


# ---- G5 hist_window --------------------------------------------------------

def _hist_case(rng, B, V, L, D, HL1, fp, hist_t, offset=False, empty=()):
    """One seeded G5 case: per env a random share of running vehicles on a
    random two thirds of its D drivables (lanes first: L of them, so some
    lanes are empty), each drivable's vehicles a chain from its rear
    (last_of) along `leader` to its front (leader -1); the other slots'
    leaders random (never walked); speeds random, some 0; each env's ring
    rows filled up to its own hist_t (below, at and past HL1: the wrap),
    the window sums their totals. The envs in `empty` have no vehicle."""
    t = np.float32 if fp == "f32" else np.float64
    running = np.zeros((B, V), bool)
    drv = rng.integers(-1, D, (B, V)).astype(np.int32)
    leader = rng.integers(-1, V, (B, V)).astype(np.int32)
    last_of = np.full((B, D), -1, np.int32)
    for b in range(B):
        if b in empty:
            continue
        slots = rng.choice(V, rng.integers(0, V + 1), replace=False)
        used = rng.choice(D, max(1, 2 * D // 3), replace=False)
        dv = rng.choice(used, slots.size)
        for d in used:
            vs = slots[dv == d]            # front first
            if vs.size:
                leader[b, vs] = np.concatenate([[-1], vs[:-1]])
                last_of[b, d] = vs[-1]
        running[b, slots] = True
        drv[b, slots] = dv
    speed = rng.uniform(0.0, 25.0, (B, V)).astype(t)
    speed[rng.random((B, V)) < 0.1] = 0.0
    hist_t = np.asarray(hist_t, np.int32)
    num = np.zeros((B, HL1, L), t)
    for b in range(B):
        num[b, :min(int(hist_t[b]), HL1)] = rng.integers(
            0, 12, (min(int(hist_t[b]), HL1), L))
    ssum = (num * rng.uniform(0.0, 16.7, num.shape)).astype(t)
    return dict(last_of=last_of, leader=leader, speed=speed, ring_num=num,
                ring_ssum=ssum, hist_num=num.sum(1).astype(t),
                hist_ssum=ssum.sum(1).astype(t), hist_t=hist_t,
                running=running, drv=drv, L=L, offset=offset)


def _hist_ts(B, HL1):
    """hist_t of B envs: below, at and past HL1, several rings round."""
    base = [0, 3, HL1 - 1, HL1, HL1 + 2, 3 * HL1 + 1]
    return [base[b % len(base)] + b // len(base) for b in range(B)]


# name -> (B, V, L, D, HL1, float type, keywords of _hist_case)
HIST_SPECS = {
    "B1_V16_L4_H5_f64": (1, 16, 4, 6, 5, "f64", {}),
    "B4_V64_L10_H5_f64": (4, 64, 10, 14, 5, "f64", {}),
    "B3_V200_L30_H241_f64": (3, 200, 30, 40, 241, "f64", {}),
    "B2_V40_L6_H4_f64_empty": (2, 40, 6, 8, 4, "f64", dict(empty=(0,))),
    "B3_V130_L17_H9_f32": (3, 130, 17, 20, 9, "f32", {}),
    "B128_V256_L40_H7_f32": (128, 256, 40, 50, 7, "f32", dict(empty=(9,))),
    "B130_V96_L12_H241_f64": (130, 96, 12, 15, 241, "f64", {}),
    "B3_V64_L8_H5_f32_offset": (3, 64, 8, 10, 5, "f32", dict(offset=True)),
}
HIST_CASES = tuple(HIST_SPECS)


def hist_case(name, seed=0):
    """The G5 case `name` (one of HIST_CASES), from its own seed."""
    B, V, L, D, HL1, fp, kw = HIST_SPECS[name]
    return _hist_case(np.random.default_rng(
        [seed, 11000 + HIST_CASES.index(name)]), B, V, L, D, HL1, fp,
        _hist_ts(B, HL1), **kw)


def hist_cases(seed=0):
    """(name, case) for each of HIST_CASES."""
    for name in HIST_CASES:
        yield name, hist_case(name, seed)


def hist_args(case, device):
    """The case as hist_window's arguments on `device`, fresh tensors on
    every call (the in-place form writes them); with `offset` every tensor
    a view one element into a larger buffer."""
    T = lambda a: _tensor(np.array(a), device, case["offset"])  # copies
    return tuple(T(case[k]) for k in (
        "last_of", "leader", "speed", "ring_num", "ring_ssum", "hist_num",
        "hist_ssum", "hist_t"))


# ---- O2 phase_pressure -----------------------------------------------------

# phase_rl_avail values: at, just above and below the 0.5 threshold, NaN
_AV_SET = np.float32([0.0, 1.0, 0.5, 0.50001, 0.49999, np.nan, 1.0, 0.0])


def _pressure_case(rng, B, P, G, LPI, virt=2, IL=4, TP=None, MAXRL=None,
                   wmax=6):
    """One seeded O2 case: G real and `virt` virtual intersections, LPI
    links each over N = 4 * (G + virt) lanes. Random: in_src (-1 too),
    start_src, end_src and rl_src (-1 each on some links; rl_src's
    column another intersection's on some), phase_rl_avail from 0, 1, 0.5
    and NaN, g_phase_offset from below 0 to past TP - P (clipped at both
    ends), g_n_phases from 0 to P + 2, waiting counts 0 to `wmax` (ties
    between phases). Crafted: intersection 0 has 0 phases (all -inf,
    action 0); intersection 1's phases 0 and 1 have equal availability
    (a tie: the first wins) and its offset sits at TP - 1 (every phase
    clipped to the last row); the last intersection has every link's
    rl_src -1."""
    I = G + virt
    N = 4 * I
    TP = TP or P + 5
    MAXRL = MAXRL or LPI + 2
    in_src = rng.integers(-1, N, (IL, G)).astype(np.int32)
    start_src = rng.integers(-1, IL * G, LPI * G).astype(np.int32)
    end_src = rng.integers(-1, N, LPI * G).astype(np.int32)
    rl = rng.integers(0, MAXRL, LPI * G)
    col = np.tile(np.arange(G), LPI)
    other = rng.random(LPI * G) < 0.2
    col = np.where(other, rng.integers(0, G, LPI * G), col)
    rl_src = np.where(rng.random(LPI * G) < 0.1, -1,
                      rl * G + col).astype(np.int32)
    pra = _AV_SET[rng.integers(0, len(_AV_SET), (TP, MAXRL))]
    g_off = rng.integers(-3, TP, G).astype(np.int32)
    g_nph = rng.integers(0, P + 3, G).astype(np.int32)
    w = rng.integers(0, wmax + 1, (N, B)).astype(np.int32)
    g_nph[0] = 0
    if G > 1:
        g_nph[1] = max(P, 2)
        g_off[1] = TP - 1
        # links of intersection 1 whose roadlinks are its own: the same
        # row for every phase (offset clipped), so phases 0 and 1 tie
        mine = (col == 1) & (rl_src >= 0)
        rl_src[np.arange(LPI * G) % G == 1] = np.where(
            mine[np.arange(LPI * G) % G == 1],
            rl_src[np.arange(LPI * G) % G == 1], -1)
    if G > 2:
        rl_src[np.arange(LPI * G) % G == G - 1] = -1
    return dict(w=w, P=P, I=I, tabs=dict(
        start_src=start_src, in_src=in_src, end_src=end_src,
        rl_src=rl_src, phase_rl_avail=pra, g_phase_offset=g_off,
        g_n_phases=g_nph))


# name -> (B, P, G, LPI, keywords of _pressure_case)
PRESSURE_SPECS = {
    "B1_P1_G5_L3": (1, 1, 5, 3, {}),
    "B3_P5_G7_L12": (3, 5, 7, 12, {}),
    "B128_P8_G9_L12": (128, 8, 9, 12, dict(wmax=2)),
    "B130_P33_G6_L5": (130, 33, 6, 5, {}),
    "B3_P64_G4_L7": (3, 64, 4, 7, dict(TP=80)),
    "B1_P16_G40_L2": (1, 16, 40, 2, dict(virt=0)),
    # more lanes an intersection than a block stages at once (8 for 32
    # rows of 4 envs, 64 for 4 rows of 32 envs)
    "B3_P4_G5_L40": (3, 4, 5, 40, {}),
    "B33_P17_G20_L300": (33, 17, 20, 300, dict(MAXRL=40)),
}
PRESSURE_CASES = tuple(PRESSURE_SPECS)


def pressure_case(name, seed=0):
    """The O2 case `name` (one of PRESSURE_CASES), from its own seed."""
    B, P, G, LPI, kw = PRESSURE_SPECS[name]
    return _pressure_case(np.random.default_rng(
        [seed, 12000 + PRESSURE_CASES.index(name)]), B, P, G, LPI, **kw)


def pressure_cases(seed=0):
    """(name, case) for each of PRESSURE_CASES."""
    for name in PRESSURE_CASES:
        yield name, pressure_case(name, seed)


def pressure_args(case, device):
    """The case as phase_pressure's (w, tabs, P, I) on `device` (a fresh
    tables dict: the wrapper keeps its link table there)."""
    import torch
    T = lambda a: torch.as_tensor(a, device=device)
    return (T(case["w"]), {k: T(v) for k, v in case["tabs"].items()},
            case["P"], case["I"])


# ---- R2 ring_exits (the exits stage) ---------------------------------------

def _exits_case(rng, B, SL, XK, lc=False, lights=True, N=24, LPI=3, G=4,
                SK=6, AP=2, virt=2, k_phase=3, offset=False, dt=1.0):
    """One seeded R2 exits case: N lanes of SL slots, LPI * G links of SK
    slots, AP approach rows, G + virt intersections, B envs. Random per
    (lane, env): n_l from 0 to SL (empty and full lanes on purpose), the
    occupied slots' new distances front first around the lane's length
    (the first few past it, so the leave prefix runs), some crossing at a
    slot >= XK behind one that does not (OV_HOPS; none in every fourth
    env, from env 1), NaN and -0.0 among them, garbage in the free slots;
    last, nxt (-1 with last unset: the invalid clamp, past the end and
    not), sh under lane change, enter
    times and steps. Links: n_k from 0 to SK, their distances alike,
    several failing slots (occupied and not) with foes from -1, failing
    red and non-red approach rows. Lights: phases and remaining times
    around 0 (k_phase passes), intersections with 0, 1 and several phases
    and virtual ones; `lights` False is RL control (the lights kept)."""
    I = G + virt
    LK = LPI * G
    ln_len = rng.uniform(20.0, 200.0, N).astype(np.float32)
    lk_len = rng.uniform(5.0, 30.0, LK).astype(np.float32)
    n_l = rng.integers(0, SL + 1, (N, B)).astype(np.int32)
    n_l[0] = 0
    n_l[1] = SL
    # front first: the first k slots past the end, then descending
    k = rng.integers(0, XK + 2, (N, B))
    pos = np.arange(SL)[:, None, None]
    past = ln_len[None, :, None] + rng.uniform(0.01, 12.0, (SL, N, B))
    before = ln_len[None, :, None] - rng.uniform(0.01, 1.0, (SL, N, B)) \
        * pos * 5.0 - rng.uniform(0.0, 3.0, (SL, N, B))
    nd = np.where(pos < k[None], past, before)
    # a slot past the end behind one that is not (past the prefix)
    deep = (rng.random((SL, N, B)) < 0.03) & (np.arange(B) % 4 != 1)
    nd = np.where(deep, past, nd)
    r = rng.random((SL, N, B))
    nd[r < 0.01] = np.nan
    nd[(r >= 0.01) & (r < 0.02)] = -0.0
    free = pos >= n_l[None]
    nd = np.where(free & (rng.random((SL, N, B)) < 0.5),
                  ln_len[None, :, None] + 50.0, nd).astype(np.float32)
    l_last = rng.random((SL, N, B)) < 0.3
    l_nxt = rng.integers(0, 2 * LK, (SL, N, B)).astype(np.int32)
    inval = rng.random((SL, N, B)) < 0.25
    l_nxt[inval] = -1
    l_sh = (rng.random((SL, N, B)) < 0.3) if lc else None
    l_enter = rng.uniform(0.0, 240.0, (SL, N, B)).astype(np.float32)
    step = rng.integers(500, 900, B).astype(np.int32)
    n_k = rng.integers(0, SK + 1, (LK, B)).astype(np.int32)
    posk = np.arange(SK)[:, None, None]
    kk = rng.integers(0, XK + 2, (LK, B))
    ndk = np.where(posk < kk[None],
                   lk_len[None, :, None] + rng.uniform(0.01, 5.0,
                                                       (SK, LK, B)),
                   lk_len[None, :, None] - rng.uniform(0.1, 3.0,
                                                       (SK, LK, B)) * posk)
    ndk = np.where((rng.random((SK, LK, B)) < 0.03)
                   & (np.arange(B) % 4 != 1),
                   lk_len[None, :, None] + 1.0, ndk).astype(np.float32)
    k_fail = rng.random((SK, LPI, G, B)) < 0.3
    k_fffoe = rng.integers(-1, 40, (SK, LPI, G, B)).astype(np.int32)
    ap_fail = rng.random((AP, LPI, G, B)) < 0.5
    ap_red = rng.random((AP, LPI, G, B)) < 0.4
    ap_ffo = rng.integers(-1, 40, (AP, LPI, G, B)).astype(np.int32)
    i_nph = rng.integers(0, 5, I).astype(np.int32)
    i_nph[:3] = (0, 1, 4)
    i_virtual = np.zeros(I, bool)
    i_virtual[G:] = True
    i_virtual[2] = rng.random() < 0.5
    PT = int(i_nph.sum()) + 2
    i_off = np.concatenate([[0], np.cumsum(i_nph)[:-1]]).astype(np.int32)
    phase_time = rng.uniform(0.3, 3.0, PT).astype(np.float32)
    phase = (rng.integers(0, 8, (I, B)) % np.maximum(i_nph, 1)[:, None]) \
        .astype(np.int32)
    remain = rng.uniform(-2.0, 2.5, (I, B)).astype(np.float32)
    params = (0.0,) * 3
    return dict(
        cfg=dict(SL=SL, SK=SK, LNp=N, LKp=LK, G=G, LPI=LPI, AP=AP, XK=XK,
                 I=I, k_phase=k_phase, lane_change=lc,
                 rl_traffic_light=not lights, params=params, interval=dt),
        net=dict(ln_len=ln_len, lk_len=lk_len,
                 ln_maxoff_out=np.full(N, 1.5, np.float32),
                 ln_maxoff_in=np.full(N, 1.5, np.float32),
                 i_n_phases=i_nph, i_virtual=i_virtual,
                 i_phase_offset=i_off, phase_time=phase_time,
                 ring_f32=np.array(params + (dt,), np.float32)),
        rs=dict(n_l=n_l, l_last=l_last, l_nxt=l_nxt, l_sh=l_sh,
                l_enter=l_enter, step=step, n_k=n_k, phase=phase,
                phase_remain=remain),
        mid=dict(new_dis_l=nd, nd_k3=ndk.reshape(SK, LPI, G, B),
                 k_fail=k_fail, k_fffoe=k_fffoe, ap_fail=ap_fail,
                 ap_red=ap_red, ap_ffo=ap_ffo),
        offset=offset)


# name -> (B, SL, XK, keywords of _exits_case)
EXITS_SPECS = {
    "B1_S8_XK2": (1, 8, 2, {}),
    "B3_S40_XK2_lc": (3, 40, 2, dict(lc=True)),
    "B128_S40_XK2": (128, 40, 2, dict(N=70)),
    "B130_S12_XK3_lc": (130, 12, 3, dict(lc=True, k_phase=2, dt=0.5)),
    "B3_S1_XK1": (3, 1, 1, dict(SK=1)),
    "B3_S40_XK2_rl": (3, 40, 2, dict(lights=False)),
    # more lanes and links than one block's group (256 at B = 3)
    "B3_S20_XK2_wide": (3, 20, 2, dict(N=300, LPI=5, G=60, virt=3)),
    "B1_S30_XK4_lc_wide": (1, 30, 4, dict(lc=True, N=1100, LPI=6, G=200)),
    # every tensor a view one element into a larger buffer (in place)
    "B3_S16_XK2_offset": (3, 16, 2, dict(offset=True, lc=True)),
}
EXITS_CASES = tuple(EXITS_SPECS)


def exits_case(name, seed=0):
    """The R2 exits case `name` (one of EXITS_CASES), from its own seed."""
    B, SL, XK, kw = EXITS_SPECS[name]
    return _exits_case(np.random.default_rng(
        [seed, 13000 + EXITS_CASES.index(name)]), B, SL, XK, **kw)


def exits_cases(seed=0):
    """(name, case) for each of EXITS_CASES."""
    for name in EXITS_CASES:
        yield name, exits_case(name, seed)


def exits_args(case, device):
    """The case as ring_exits' (cfg, net, rs, mid) on `device`, fresh
    tensors on every call (the exits stage clamps mid["new_dis_l"] in
    place); cfg, net and rs carry only what the stage reads."""
    from types import SimpleNamespace
    T = lambda a: None if a is None else _tensor(np.array(a), device,
                                                 case["offset"])
    mid = {k: T(v) for k, v in case["mid"].items()}
    return (SimpleNamespace(**case["cfg"]),
            {k: T(v) for k, v in case["net"].items()},
            SimpleNamespace(**{k: T(v) for k, v in case["rs"].items()}),
            mid)
