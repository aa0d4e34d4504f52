"""Build and load the port's CUDA kernels (counterpart of the loading
half of `paddle_tpu/ops/kern/registry.py`).

Each source `paddle_tpu_torch/csrc/<name>.cu` is compiled at first use
with `nvcc` for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into
a shared library with a plain C interface under
``build/paddle_tpu_torch/`` at the root of the checkout, and loaded
with `ctypes`. `build` compiles several sources at once, one `nvcc`
process each. The library's file name carries a digest of its source
and flags, so an edited source is rebuilt and never meets a stale
library. A failed build or load raises; there is no fallback.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "function"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
# no -use_fast_math and no -prec-div=false: the quantize kernel's codes
# must match the reference's IEEE divisions bit for bit; -Xptxas -v
# reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}              # name -> ctypes.CDLL


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the "
        "port's CUDA kernels are built from paddle_tpu_torch/csrc at "
        "first use and need the CUDA toolkit")


def _lib_path(name):
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise RuntimeError(f"kernel source {src} is missing")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name):
    """Compile `csrc/<name>.cu` unless its library exists. Returns
    (library path, nvcc seconds, compiler output); 0.0 and "" when the
    library was there. Raises RuntimeError with the compiler's output
    if `nvcc` fails."""
    src, lib = _lib_path(name)
    if lib.is_file():
        return lib, 0.0, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed: {name}.cu (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)         # atomic: readers never see a torn .so
    return lib, seconds, proc.stdout


def build(names=None):
    """Compile every `csrc/<name>.cu` in `names` (default: every source
    in `csrc/`) that has no library yet, one `nvcc` each, all started
    together. Returns {name: (nvcc seconds, compiler output)}. Raises
    on the first failure."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futs = {n: pool.submit(_compile, n) for n in names}
        done = {n: f.result() for n, f in futs.items()}
    return {n: (sec, out) for n, (_lib, sec, out) in done.items()}


def load(name):
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _compile(name)[0]
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(
                    f"could not load kernel library {path}: {e}") from e
            _LIBS[name] = lib
    return lib


def function(name, symbol, argtypes):
    """The C entry point `symbol` of `csrc/<name>.cu`, with its argument
    types set (ctypes.c_void_p for pointers and the stream) and an int
    return code."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
