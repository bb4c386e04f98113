"""Native (C++) scenario-compile kernel, loaded via ctypes.

Conflict-cross discovery is O(links^2 * segments^2) per intersection:
minutes in Python for a 30x30 grid, under a second in C++. The C++ results
are bit-identical to the Python implementation in compiler/roadnet.py (same
IEEE double op order; compiled with -ffp-contract=off), which stays as the
fallback when no compiler is available.

The shared library is built at first use into `build/cityflow_tpu_torch/`
beside the package (gitignored), never into the package directory, keyed
on a hash of the source so an edited source rebuilds.
"""

import ctypes
import hashlib
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "crosses.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "cityflow_tpu_torch")

_lib = None
_tried = False


def _lib_path():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"crosses_{digest}.so")


def _build(path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           "-ffp-contract=off", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, path)


def get_lib():
    """Returns the ctypes lib, or None (the caller falls back to Python).
    Prints once which path runs."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("CITYFLOW_TPU_NO_NATIVE"):
        print("cityflow_tpu_torch: conflict crosses via the Python fallback "
              "(CITYFLOW_TPU_NO_NATIVE)", file=sys.stderr)
        return None
    try:
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"cityflow_tpu_torch: native crosses unavailable ({e}); "
              "using the Python fallback", file=sys.stderr)
        return None
    c = ctypes.c_longlong
    d = ctypes.POINTER(ctypes.c_double)
    l = ctypes.POINTER(ctypes.c_longlong)
    lib.find_crosses.restype = c
    lib.find_crosses.argtypes = [c, d, l, d, c, l, l, d, d, d, d, d]
    lib.sort_link_crosses.restype = None
    lib.sort_link_crosses.argtypes = [c, l, d]
    _lib = lib
    print(f"cityflow_tpu_torch: conflict crosses via native {path}",
          file=sys.stderr)
    return _lib
