"""Neighbour-lane reads shared by the lane-change kernels' plain versions.

A lane's inner and outer neighbour lanes are static columns of the lane
axis (compiler/ring_net.index_tables: inner_src / outer_src, -1 where there
is none). The JAX step permutes whole bundles to them (ring_lc._perm, 0 in
rows without a neighbour); the plain versions here read the column by
index with the same 0 fill, and the kernels read it in place.
"""

import torch


def nbcol(x, src):
    """x (..., LNp, B) -> x at each lane's neighbour column, 0 (False)
    where the lane has none."""
    got = x.index_select(x.dim() - 2, src.clamp(min=0).long())
    ok = (src >= 0)[:, None]
    return torch.where(ok, got, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def scalar(v, like):
    """A Python float as a float32 0-dim tensor on `like`'s device (JAX's
    f(p) constants)."""
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)
