"""Build and load the port's CUDA kernels (`kernels/csrc/*.cu`).

The sources have a plain C interface and are compiled with `nvcc` for
`sm_90a` into one shared library, loaded with `ctypes`. The build happens at
first use, into `build/repro_torch_kernels/<hash>/` at the repository root
(`.gitignore` lists `build/`), keyed on a hash of the sources and the flags,
so an edited source rebuilds and an unchanged one loads at once. Each source
compiles to an object in its own `nvcc` process, all started together; one
link step then makes the library.

No `--use_fast_math`: the kernels rely on IEEE division and `expf`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("nvfp4_quant.cu", "fp4_matmul.cu", "paged_attention.cu",
           "ms_eden_requant.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# every pointer and the stream are c_void_p, so no pointer is cut to 32 bits
SIGNATURES = {
    "nvfp4_fos_quant_launch": (_P, _I, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I,
                               _F, _F, _F, _P),
    "fp4_matmul_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I,
                          _I, _I, _P),
    "paged_gqa_launch": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                         _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _L, _L, _L,
                         _P),
    "paged_mla_launch": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _P)
                        + (_L,) * 11 + (_F, _P),
    "paged_mla_q_launch": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P)
                          + (_L,) * 11 + (_F, _P),
    "ms_eden_phase1_launch": (_P, _L, _I, _I, _P, _P, _P, _P, _P, _P, _L, _L,
                              _I, _F, _F, _P),
    "ms_eden_phase2_launch": (_P, _P, _P, _P, _P, _P, _P, _L, _L, _L) * 2
                             + (_F, _P),
}

_LIB = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path. A library already built from the same sources is reused."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    # objects go to a directory of this process's own, and the library lands
    # by an atomic rename, so concurrent first builds cannot mix their files
    tmp_dir = out_dir / f".build.{os.getpid()}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = tmp_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for name, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out}")
        objs.append(str(obj))
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = tmp_dir / "librepro_torch_kernels.so"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    BUILD_INFO.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      cached=False, log="\n".join(logs))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for fn, args in SIGNATURES.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(status: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
