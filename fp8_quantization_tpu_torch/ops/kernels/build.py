"""Build and load the hand-written CUDA kernels (no JAX counterpart).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, under ``build/kernels/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and flags, and uses only the
sources in this package.  ``build_all`` starts one ``nvcc`` per source at
once and waits for all of them.

Each C entry returns ``cudaGetLastError()``; ``check`` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("qmatmul", "qconv", "qstem", "qmatmul_int8", "qmatmul_s8_sm90",
           "qconv_int8", "qdwconv", "qblock", "flash_mha")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points, in the order of their arguments.
SIGNATURES = {
    "qmatmul": ("qmatmul_launch",
                [_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                 _I, _I, _I, _P]),
    "qconv": ("qconv3x3_launch",
              [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
               _I, _I, _P]),
    "qstem": ("qstem_launch",
              [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "qmatmul_int8": ("qmatmul_int8_launch",
                     [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _P]),
    "qmatmul_s8_sm90": ("qmatmul_s8_sm90_launch", [_P] * 9 + [_I] * 8 + [_P]),
    "qconv_int8": ("qconv3x3_int8_launch",
                   [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _I, _I, _I, _I, _I, _I, _I, _P]),
    "qdwconv": ("qdwconv3x3_launch", [_P] * 6 + [_I] * 11 + [_P]),
    "qblock": ("qblock_launch", [_P] * 13 + [_I] * 18 + [_P]),
    "flash_mha": ("flash_mha_launch",
                  [_P, _P, _P, _I] + [_L] * 9 + [_P] + [_I] * 6 + [_F, _P]),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build_hash() -> str:
    """The identity of the kernel build: a hash of the flags and of every
    source.  The build directory and the autotune cache (ops/kernels/
    autotune.py) are keyed by it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build_dir() -> Path:
    return BUILD_ROOT / build_hash()


def _lib_path(name: str) -> Path:
    return _build_dir() / f"lib{name}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=KERNELS) -> float:
    """Compile every kernel that is not built yet, one nvcc each, all at
    once; returns the seconds taken.  Raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    procs = [_start(n) for n in names if not _lib_path(n).exists()]
    errors = []
    try:
        for proc, tmp, out in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{out.name}: nvcc exit {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
    finally:
        for proc, tmp, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        if name not in _loaded:
            if not _lib_path(name).exists():
                build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def entry(name: str):
    """The C launch function of one kernel."""
    return getattr(library(name), SIGNATURES[name][0])


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
