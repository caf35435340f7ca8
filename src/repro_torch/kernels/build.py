"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into an object
file, all sources in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library lives
under ``build/repro_torch/<hash of the sources>/`` at the repository root,
so an edit to any source builds afresh and an unchanged tree reuses the
last build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint

#: C entry points and their argument types. Every one returns the
#: ``cudaError_t`` of its launch (0 = launched).
SIGNATURES = {
    "repro_partition_hist": (_P, _P, _LL, _I, _I, _P, _P, _P),
    "repro_tiled_probe": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    "repro_tiled_probe3": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P, _P),
    "repro_bitonic_sort": (_P, _P, _I, _I, _P, _P, _P),
    "repro_bloom_build": (_P, _P, _LL, _I, _I, _U, _U, _I, _P, _P, _P),
    "repro_bloom_probe": (_P, _LL, _P, _I, _I, _U, _U, _I, _P, _P),
    "repro_key_range": (_P, _P, _LL, _I, _P, _P, _P),
    "repro_move_rows": (_P, _I, _LL, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P,
                        _P),
}

#: ptxas reports and timings of the last build in this process.
build_log: dict = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile the sources (if this tree's build is missing) and return the
    shared library's path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_log.update(cached=True, seconds=0.0)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        reports, failed = {}, []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            reports[src.name] = out
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_lib), *(str(obj) for _s, obj, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, lib)  # atomic: a reader never sees half a file
    build_log.update(cached=False, seconds=time.perf_counter() - t0,
                     ptxas=reports)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call, with every entry
    point's argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = (ctypes.c_int,)
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch was refused (its ``cudaGetLastError`` was not 0)."""
    if err != 0:
        text = library().repro_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({text})")
