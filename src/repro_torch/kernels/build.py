"""Build and load the port's CUDA C++ kernels (``nvcc`` + ``ctypes``).

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled for Hopper (``sm_90a``) into ``repro_torch/_build/`` under a
name keyed on a hash of its source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source or header builds anew and an
unchanged one loads at once.  Nothing is built at import
time: a machine without ``nvcc`` or a card imports the package freely
and only the CUDA launch path needs the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: Hopper only (``wgmma``/``setmaxnreg`` need the ``a`` target); no
#: fast-math and no multiply-add contraction, so the kernels round like
#: their plain PyTorch versions (see the note in ``csrc/cc_step.cu``).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0 = loaded
#: from an existing build)
BUILD_SECONDS: dict[str, float] = {}


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of repro_torch are compiled at first use")


def sources() -> list[str]:
    """The port's CUDA sources (``csrc/*.cu``), one library each."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in [f"{name}.cu"] + sorted(f for f in os.listdir(CSRC)
                                      if f.endswith(".cuh")):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(fn.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{key[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists;
    returns the library path.  The build goes to a temporary file that
    is renamed into place, so concurrent builders never see half a
    library."""
    out = library_path(name)
    if os.path.exists(out):
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with every entry point's
    types declared from ``signatures`` ({symbol: (argtypes, restype)})."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        for sym, (argtypes, restype) in signatures.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIBS[name] = lib
    return lib
