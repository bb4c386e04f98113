"""T1 tpl_params: vehicle template index -> template parameters
(csrc/tpl_params.cu).

Every vehicle carries its flow's template (VehicleInfo, vehicle.h:31-45);
on the non-uniform ring path the rings carry the template index and the
step reads parameters per slot through this. For an int32 index tensor of
any shape and the (TP, 12) float32 table, returns (len(cols), *shape)
float32: row c is column cols[c] of each element's template, 0 where the
index lies outside [0, TP) (what the JAX one-hot einsum gives there).
"""

import ctypes

import torch

from cityflow_tpu_torch.kernels import _lib

launches = 0
NPARAM = 12
MAX_TP = 1024           # the kernel keeps TP x ncols floats in shared memory


class _Args(ctypes.Structure):
    _fields_ = [("tpl", ctypes.c_void_p), ("table", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("TP", ctypes.c_int), ("ncols", ctypes.c_int),
                ("cols", ctypes.c_ulonglong)]


def tpl_params_plain(tpl, table, cols):
    """Plain PyTorch version: a gather of the table's columns."""
    TP = table.shape[0]
    tc = table.t()[list(cols)]                            # (ncols, TP)
    got = tc[:, tpl.clamp(0, TP - 1).long()]
    ok = (tpl >= 0) & (tpl < TP)
    return torch.where(ok[None], got, torch.zeros((), device=got.device))


def tpl_params(tpl, table, cols):
    """T1 on CUDA tensors, the plain version on CPU tensors."""
    global launches
    cols = tuple(int(c) for c in cols)
    if not cols or len(cols) > NPARAM or not all(0 <= c < NPARAM
                                                for c in cols):
        raise ValueError(f"tpl_params: columns {cols}")
    if table.dim() != 2 or table.shape[1] != NPARAM \
            or not 1 <= table.shape[0] <= MAX_TP:
        raise ValueError(f"tpl_params: table {tuple(table.shape)}")
    cpu = tpl.device.type == "cpu"
    _lib.check_args("tpl_params", tpl, table,
                    dtypes=[(torch.int32,), (torch.float32,)], cuda=not cpu)
    if cpu:
        return tpl_params_plain(tpl, table, cols)
    out = torch.empty((len(cols),) + tuple(tpl.shape), dtype=torch.float32,
                      device=tpl.device)
    a = _Args(tpl.data_ptr(), table.data_ptr(), out.data_ptr(), tpl.numel(),
              table.shape[0], len(cols),
              sum(c << (4 * i) for i, c in enumerate(cols)))
    rc = _lib.lib().tpl_params(ctypes.byref(a), _lib.stream_ptr(tpl))
    _lib.check(rc, "tpl_params")
    launches += 1
    return out
