"""K1 gather_rows: the exact gather that replaces the ring step's one-hot
operators (csrc/gather_rows.cu).

    out[c, j, b] = x[c, idx[j], b]       if idx[j] >= 0       else fill

x is (C, N, B) with the env axis B last; idx is a static (J,) int32 table.
Works on any 4-byte dtype (float32 or int32). The plain version also
takes a per-(j, b) int32 index `didx` (the dynamic to_link / from_link
selections of R5's and R7's plain versions):

    out[c, j, b] = x[c, didx[j, b], b]   if didx[j, b] >= 0   else fill

whose kernels pack those selections themselves.
"""

import struct

import torch

from cityflow_tpu_torch.kernels import _lib

launches = 0


def gather_rows_plain(x, idx=None, fill=0.0, didx=None):
    """Plain PyTorch version (the CPU path and the kernel's yardstick)."""
    C, _, B = x.shape
    if didx is None:
        got = x.index_select(1, idx.clamp(min=0).long())
        ok = (idx >= 0)[None, :, None]
    else:
        J = didx.shape[0]
        got = torch.gather(x, 1, didx.clamp(min=0).long()[None]
                           .expand(C, J, B))
        ok = (didx >= 0)[None]
    return torch.where(ok, got, torch.tensor(fill, dtype=x.dtype,
                                             device=x.device))


def gather_rows(x, idx, fill=0.0, out=None):
    """K1 on a CUDA tensor, the plain version on a CPU tensor."""
    global launches
    if x.dim() != 3:
        raise ValueError(f"gather_rows: x must be (C, N, B), got {x.shape}")
    C, N, B = x.shape
    J = idx.shape[0]
    cpu = x.device.type == "cpu"
    _lib.check_args("gather_rows", x, idx, out,
                    dtypes=[(torch.float32, torch.int32), (torch.int32,),
                            (x.dtype,)], cuda=not cpu)
    if idx.dim() != 1:
        raise ValueError(f"gather_rows: idx {tuple(idx.shape)} is not (J,)")
    if cpu:
        res = gather_rows_plain(x, idx, fill)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if out is None:
        out = torch.empty((C, J, B), dtype=x.dtype, device=x.device)
    elif tuple(out.shape) != (C, J, B):
        raise ValueError(f"gather_rows: out {tuple(out.shape)} != {(C, J, B)}")
    if x.dtype == torch.float32:
        fill_bits = struct.unpack("<I", struct.pack("<f", float(fill)))[0]
    else:
        fill_bits = int(fill) & 0xFFFFFFFF
    rc = _lib.lib().gather_rows(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                C, N, J, B, fill_bits, _lib.stream_ptr(x))
    _lib.check(rc, "gather_rows")
    launches += 1
    return out
