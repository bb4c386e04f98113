"""R4 route_rows: the route-table rows of this step's link -> lane
transfers (csrc/route_rows.cu).

A vehicle leaving link slot xs < XKe of link (l, g) enters the link's end
lane; its payload there is its route's next hop at (route, rpos + 1, the
end lane's local index): nxt, the two-hop nxt3 = (aux >> 1) - 2 and last =
aux & 1 (compiler/ring_net route_aux), and under lane change the MAXLPR
entries of route_next / route_aux at (route, rpos + 1). Per intersection g
and env b the candidate rows j = xs * LPI + l are taken in order, and the
first TI exits get their payloads; the other rows take the fills (-1, -1,
0, and -1 for the lane-change rows). More than TI exits at one
intersection set OV_REMOVE. There is no per-env cap: the JAX step's second
compaction to 1024 rows is not repeated (a pinned divergence:
test_torch_ring.py::test_route_rows_above_the_transfer_cap_match_a_direct_
lookup).

exit_flags (XKe, LKp, B) bool, k_route / k_rpos (SK, LKp, B) int32. Returns
(pays, ov): pays (3 [+ 2 * MAXLPR], XKe, LKp, B) int32 (nxt, nxt3, last,
[rn0.., ax0..]), ov the OV_REMOVE bits per env (B,) int32.
"""

import ctypes

import torch

from cityflow_tpu_torch.core.numerics import jnp_take
from cityflow_tpu_torch.core.state import OV_REMOVE
from cityflow_tpu_torch.kernels import _lib

launches = 0
launches_lc = 0        # of those, with the lane-change rows
I32 = torch.int32


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "exit_flags", "k_route", "k_rpos", "lk_end_lane", "ln_llocal",
        "route_next", "route_aux", "pays", "ov")] \
        + [(n, ctypes.c_longlong) for n in (
            "XKe", "LPI", "G", "B", "LNp", "NR", "RLEN", "MAXLPR", "TI",
            "lc")]


def route_rows_plain(cfg, net, exit_flags, k_route, k_rpos):
    """Plain PyTorch version (the ring step's route compaction as it stood
    inline: a stable sort of the exits to the front of each intersection's
    candidate rows, the route-table gathers on the first TI, a scatter
    back; JAX ring.py:1567-1642 without the second compaction)."""
    LPI, G = cfg.LPI, cfg.G
    dev = exit_flags.device
    XKe, LKp, B = exit_flags.shape
    ln_llocal = net["ln_llocal"]
    rn = net["route_next"]
    NR, RLEN, MAXLPR = rn.shape
    TI = min(cfg.TI, XKe * LPI)
    NC = XKe * LPI
    ef3 = exit_flags.reshape(NC, G, B)
    ov = (ef3.to(I32).sum(0) > TI).any(0).to(I32) * OV_REMOVE
    src_iota = torch.arange(NC, dtype=I32, device=dev)[:, None, None] \
        .expand(NC, G, B)
    key = torch.where(ef3, src_iota, NC)
    endl_local = jnp_take(ln_llocal, net["lk_end_lane"].clamp(min=0)) \
        .reshape(1, LPI, G, 1)
    rowb3 = ((k_route[:XKe].reshape(XKe, LPI, G, B).clamp(0, NR - 1)
              * RLEN + (k_rpos[:XKe].reshape(XKe, LPI, G, B) + 1)
              .clamp(0, RLEN - 1)) * MAXLPR).reshape(NC, G, B)
    gidx3 = rowb3 + endl_local.clamp(0, MAXLPR - 1) \
        .expand(XKe, LPI, G, B).reshape(NC, G, B)
    skey, perm = torch.sort(key, dim=0, stable=True)
    perm = perm[:TI]
    gi = torch.gather(gidx3, 0, perm).clamp(0, NR * RLEN * MAXLPR - 1).long()
    r_aux = net["route_aux"].reshape(-1)[gi]
    rvals = [(rn.reshape(-1)[gi], -1), ((r_aux >> 1) - 2, -1),
             (r_aux & 1, 0)]
    if cfg.lane_change:
        # the entrant's route rows at (route, rpos + 1) for the lane-change
        # reachability checks
        b2 = torch.gather(rowb3, 0, perm)
        FMAX = NR * RLEN * MAXLPR - 1
        bis = [(b2 + c).clamp(0, FMAX).long() for c in range(MAXLPR)]
        rvals += [(rn.reshape(-1)[bi], -1) for bi in bis]
        rvals += [(net["route_aux"].reshape(-1)[bi], -1) for bi in bis]
    # scatter back to the (NC, G) candidate rows (dump row NC)
    tgt1 = torch.where(skey[:TI] < NC, skey[:TI], NC).long()
    pays = torch.stack([
        torch.full((NC + 1, G, B), fill, dtype=I32, device=dev)
        .scatter_(0, tgt1, vals.to(I32))[:-1] for vals, fill in rvals])
    return pays.reshape(len(rvals), XKe, LKp, B), ov


def route_rows(cfg, net, exit_flags, k_route, k_rpos):
    """R4 on CUDA tensors, the plain version on CPU tensors."""
    if exit_flags.dim() != 3 or exit_flags.shape[1] != cfg.LKp:
        raise ValueError(f"route_rows: exit_flags {tuple(exit_flags.shape)}")
    XKe, LKp, B = exit_flags.shape
    if tuple(k_route.shape) != (cfg.SK, LKp, B) \
            or tuple(k_rpos.shape) != (cfg.SK, LKp, B) or XKe > cfg.SK:
        raise ValueError("route_rows: link ring shapes")
    cpu = exit_flags.device.type == "cpu"
    i32 = (torch.int32,)
    _lib.check_args("route_rows", exit_flags, k_route, k_rpos,
                    dtypes=[(torch.bool,), i32, i32], cuda=not cpu)
    if cpu:
        return route_rows_plain(cfg, net, exit_flags, k_route, k_rpos)
    return _launch(cfg, net, exit_flags, k_route, k_rpos)


def _launch(cfg, net, exit_flags, k_route, k_rpos):
    global launches, launches_lc
    XKe, LKp, B = exit_flags.shape
    dev = exit_flags.device
    NR, RLEN, MAXLPR = net["route_next"].shape
    lc = cfg.lane_change
    pays = torch.empty((3 + 2 * MAXLPR * lc, XKe, LKp, B), dtype=I32,
                       device=dev)
    ov = torch.zeros((B,), dtype=I32, device=dev)
    a = _Args(exit_flags.data_ptr(), k_route.data_ptr(), k_rpos.data_ptr(),
              *(net[k].data_ptr() for k in ("lk_end_lane", "ln_llocal",
                                            "route_next", "route_aux")),
              pays.data_ptr(), ov.data_ptr(), XKe, cfg.LPI, cfg.G, B,
              cfg.LNp, NR, RLEN, MAXLPR, min(cfg.TI, XKe * cfg.LPI), int(lc))
    _lib.check(_lib.lib().route_rows(ctypes.byref(a), _lib.stream_ptr(ov)),
               "route_rows")
    launches += 1
    launches_lc += int(lc)
    return pays, ov
