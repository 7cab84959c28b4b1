"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``csrc/`` is compiled for sm_90a into a shared library
with a plain C interface, at first use, into ``_build/`` inside the package
(listed in .gitignore). Library names carry a hash of the source, the
shared device headers (``csrc/*.cuh``) and the flags,
so an edited source is rebuilt and a stale library is never loaded. All
missing libraries of one ``build_all`` call compile in parallel, one nvcc
process per source.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = {
    name: os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
    for name in ("fused_mlp_fwd", "fused_mlp_train", "fused_adam", "bitonic_argsort",
                 "raster_traverse", "raster_bin", "render_wire")
}
HEADERS = sorted(glob.glob(os.path.join(_PKG_DIR, "csrc", "*.cuh")))
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Adam, the traversal and the binning round every product and sum
# separately, like their plain twins.
EXTRA_FLAGS = {"fused_adam": ["-fmad=false"], "raster_traverse": ["-fmad=false"],
               "raster_bin": ["-fmad=false"]}

_loaded = {}


def _nvcc():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(name):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name):
    """The library's path: its name hashes the source, the shared headers
    beside it (csrc/*.cuh) and the flags."""
    h = hashlib.sha256()
    for path in [SOURCES[name]] + HEADERS:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = hashlib.sha256(h.digest() + " ".join(_flags(name)).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build_all(names=None):
    """Compile every missing library in parallel. Returns
    {name: {"path", "seconds", "ptxas"}} for the libraries built now."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = f"{library_path(n)}.tmp{os.getpid()}"
        cmd = [nvcc, *_flags(n), "-o", tmp, SOURCES[n]]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{out}{err}")
            continue
        os.replace(tmp, library_path(n))  # atomic: readers never see a partial file
        built[n] = {"path": library_path(n),
                    "seconds": time.perf_counter() - t0, "ptxas": err}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return built


def load(name):
    """ctypes handle of a kernel library, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build_all([name])
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
