"""Ring helpers shared by the ring step and the plain versions of its
front kernels (R5, R7): dynamic link indices, ring tails, priority halves.

A lane front's next link is a global drivable id; lpi_of turns it into
the local link index of its intersection, from_link_idx into the link row
an in-lane reads, to_link_idx into the in-lane row a link reads (the link
takes the front of its start in-lane iff that front's next link is the
link). -1 means none, as the K1 index convention.
"""

import torch

I32 = torch.int32


def hilo(pri):
    """A priority's (hi, lo) 16-bit halves as float32 (the exchanges carry
    int channels as float32, exact below 2^24)."""
    return (pri >> 16).to(torch.float32), (pri & 0xFFFF).to(torch.float32)


def sel_slot(x, n):
    """x[n - 1] per column and env, 0 where the ring is empty
    ((S, N, B), (N, B) -> (N, B))."""
    got = torch.gather(x, 0, (n - 1).clamp(min=0).long()[None])[0]
    return torch.where(n > 0, got, torch.zeros_like(got))


def lpi_of(cfg, nxt_ids):
    """(IL, G, B) next-link ids -> local link index (or -1)."""
    g = torch.arange(cfg.G, dtype=I32, device=nxt_ids.device)[None, :, None]
    return torch.where(nxt_ids >= 0, torch.div(
        nxt_ids - cfg.LNp - g, cfg.G, rounding_mode="floor"), -1)


def to_link_idx(cfg, net, lpi_h):
    """(LKp, B) in-lane row each link reads (or -1)."""
    src = net["start_src"].long()                            # (LKp,)
    B = lpi_h.shape[-1]
    lp = lpi_h.reshape(cfg.IL * cfg.G, B)[src.clamp(min=0)]  # (LKp, B)
    l_of = torch.arange(cfg.LKp, device=lpi_h.device) // cfg.G
    ok = (src >= 0)[:, None] & (lp == l_of[:, None])
    return torch.where(ok, src[:, None], -1).to(I32)


def from_link_idx(cfg, lpi_h):
    """(IL * G, B) link row each in-lane reads (or -1)."""
    g = torch.arange(cfg.G, dtype=I32, device=lpi_h.device)[None, :, None]
    ok = (lpi_h >= 0) & (lpi_h < cfg.LPI)
    return torch.where(ok, lpi_h * cfg.G + g, -1) \
        .reshape(cfg.IL * cfg.G, -1).to(I32).contiguous()
