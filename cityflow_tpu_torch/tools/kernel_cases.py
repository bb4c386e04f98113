"""Seeded edge cases of K4 ring_commit and T1 tpl_params.

The same cases feed the CPU tests (tests/test_torch_commit_cases.py: the
plain versions against a slot-by-slot numpy walk) and chip_smoke.py (the
kernels against the plain versions on the card, bit for bit), so what the
kernels are held to on the card is what the tests show right on the CPU.

    for name, case in commit_cases():
        args, kw = commit_args(case, device)     # ring_commit(*args, **kw)
    for name, case in tpl_cases():
        tpl, table, cols = tpl_args(case, device)

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
