"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled for sm_90a with nvcc into one shared library with
a plain C interface, loaded through ctypes. The build runs at first use,
into `build/cityflow_tpu_torch/` beside the package, keyed on a hash of the
sources; each source compiles in its own nvcc process, all started
together, and one more nvcc links them.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC

--fmad=false and no --use_fast_math: the kernels round every float op on
its own, like the plain PyTorch versions they are checked against.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cityflow_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of the build in this process (None: cached)


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH):"
                           " the CUDA kernels cannot be built")
    return found


def _build(path):
    nvcc = _nvcc()
    tmpdir = f"{path}.{os.getpid()}.objs"
    os.makedirs(tmpdir, exist_ok=True)
    procs = []
    for src in _sources():
        if not src.endswith(".cu"):
            continue
        obj = os.path.join(tmpdir, os.path.basename(src) + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-Xptxas", "-v", "-c", src,
               "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    objs, logs = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{logs[-1]}")
        objs.append(obj)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", tmp],
                   check=True, capture_output=True)
    os.replace(tmp, path)
    shutil.rmtree(tmpdir, ignore_errors=True)
    with open(path + ".ptxas.txt", "w") as f:
        f.write("\n".join(logs))


def lib():
    """The loaded kernel library; builds it on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256()
        for src in _sources():
            with open(src, "rb") as f:
                h.update(os.path.basename(src).encode() + f.read())
        path = os.path.join(BUILD_DIR, f"kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.time()
            _build(path)
            build_seconds = time.time() - t0
        L = ctypes.CDLL(path)
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        L.gather_rows.argtypes = [vp, vp, vp, vp, ll, ll, ll, ll,
                                  ctypes.c_uint, vp]
        L.gather_rows.restype = ctypes.c_int
        for name in ("cross_caps", "car_follow", "ring_commit", "lc_signal",
                     "lc_receive", "lc_insert", "lc_partner", "lane_stats",
                     "phase_pressure", "arrange", "leader_scan",
                     "notify_cross", "cross_pass", "tpl_params",
                     "hist_window", "lc_probe", "blocker_cycles",
                     "update_location"):
            fn = getattr(L, name)
            fn.argtypes = [vp, vp]
            fn.restype = ctypes.c_int
        for name in ("lc_plan", "lc_commit"):    # (args, mode, stream)
            fn = getattr(L, name)
            fn.argtypes = [vp, ctypes.c_int, vp]
            fn.restype = ctypes.c_int
        _lib = L
        return _lib


def stream_ptr(t):
    """PyTorch's current stream on the tensor's device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream


# the float dtypes of the gen-1 kernels: float64 (exact mode) and float32
# (fast mode), one of them per call
FLOATS = (torch.float64, torch.float32)


def fp32(name, *tensors):
    """1 when the floating-point tensors among `tensors` (None skipped) are
    float32, 0 when they are float64; a call mixing the two raises."""
    kinds = {t.dtype for t in tensors
             if t is not None and t.dtype.is_floating_point}
    if len(kinds) > 1:
        raise ValueError(f"{name}: float tensors of several dtypes {kinds}")
    return int(kinds == {torch.float32})


def check(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def check_args(name, *tensors, dtypes=None, cuda=True):
    """Every tensor on one device (a CUDA one unless cuda=False),
    contiguous and of an accepted dtype (None skipped); the tensors whose
    accepted dtypes are FLOATS share one float dtype. The CPU path runs
    the same checks, so the tests catch what the kernel would refuse."""
    dev = None
    for i, t in enumerate(tensors):
        if t is None:
            continue
        if cuda and t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} is on {t.device}, "
                             "expected a CUDA tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if dtypes is not None and dtypes[i] is not None \
                and t.dtype not in dtypes[i]:
            raise ValueError(f"{name}: argument {i} has dtype {t.dtype}, "
                             f"expected one of {dtypes[i]}")
    if dtypes is not None:
        fp32(name, *(t for t, d in zip(tensors, dtypes) if d is FLOATS))
