"""Native (C++) host components, loaded through ctypes.

``bvh.cpp``, ``localtri.cpp`` and ``idt.cpp`` (byte-for-byte copies of the
JAX package's sources) are compiled with g++ at first use into the
package's ignored ``_build/``; the library name carries a hash of the
source, the flags and the host CPU, so an edited source is rebuilt, and so
is a library built with -march=native on another CPU. Each native core has
a Python reference beside it (``ops/intersect.py:intersect_rays_numpy``
for the BVH, which callers use when no compiler is available; the Python
loops of ``geometry/pointcloud.py`` and ``geometry/intrinsic_delaunay.py``,
which run only when asked for: ``load_localtri`` and ``load_idt`` raise
when their library cannot be built).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
# -ffp-contract=off: the BVH keeps exact parity with the numpy f64 oracle
# (hit and tie structure), the iDT core with its Python flip predicates;
# FMA contraction under -march=native would change the last bits of their
# dot/cross chains and break ties that numpy resolves differently.
_CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17"]

_bvh_lib = None
_localtri_lib = None
_idt_lib = None


def _host_cpu():
    """The machine and CPU model that -march=native compiles for."""
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line for line in f if line.startswith("model name")), "")
    except OSError:
        pass
    return f"{platform.machine()} {model.strip()}"


def _build(src_name, extra_flags=()):
    from ..ops._build import BUILD_DIR

    src = os.path.join(_DIR, src_name)
    flags = [*_CXX_FLAGS, *extra_flags]
    with open(src, "rb") as f:
        key = f.read() + " ".join(flags).encode() + _host_cpu().encode()
    digest = hashlib.sha256(key).hexdigest()[:12]
    lib = os.path.join(BUILD_DIR, f"lib{os.path.splitext(src_name)[0]}-{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *flags, "-o", tmp, src], check=True, capture_output=True,
                       timeout=300)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        raise RuntimeError(f"native build failed: {e}") from e
    os.replace(tmp, lib)  # atomic: readers never see a partial file
    return lib


def load_bvh():
    """ctypes handle to the BVH host tracer, or None if it cannot be built.
    Falls back to a build without OpenMP when libgomp is absent."""
    global _bvh_lib
    if _bvh_lib is not None:
        return _bvh_lib
    c = ctypes
    for flags in (("-fopenmp",), ()):
        try:
            lib = c.CDLL(_build("bvh.cpp", flags))
            break
        except (RuntimeError, OSError):
            continue
    else:
        return None
    lib.bvh_create.restype = c.c_void_p
    lib.bvh_create.argtypes = [c.c_int64, c.POINTER(c.c_double)]
    lib.bvh_destroy.restype = None
    lib.bvh_destroy.argtypes = [c.c_void_p]
    lib.bvh_trace.restype = None
    lib.bvh_trace.argtypes = [
        c.c_void_p, c.c_int64,
        c.POINTER(c.c_double), c.POINTER(c.c_double),
        c.c_double, c.c_double, c.c_double,
        c.POINTER(c.c_double), c.POINTER(c.c_int32), c.POINTER(c.c_double),
    ]
    _bvh_lib = lib
    return lib


def load_localtri():
    """ctypes handle to the local-triangulation core; raises RuntimeError
    when it cannot be built."""
    global _localtri_lib
    if _localtri_lib is None:
        c = ctypes
        lib = c.CDLL(_build("localtri.cpp"))
        lib.local_triangulation.restype = c.c_int64
        lib.local_triangulation.argtypes = [
            c.c_int64, c.POINTER(c.c_double), c.c_int64, c.POINTER(c.c_int32), c.c_int64,
        ]
        _localtri_lib = lib
    return _localtri_lib


def load_idt():
    """ctypes handle to the intrinsic-Delaunay flip core; raises
    RuntimeError when it cannot be built."""
    global _idt_lib
    if _idt_lib is None:
        c = ctypes
        lib = c.CDLL(_build("idt.cpp"))
        lib.idt_flip.restype = c.c_int64
        lib.idt_flip.argtypes = [
            c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_double),
            c.POINTER(c.c_int64), c.POINTER(c.c_double), c.c_int64,
        ]
        _idt_lib = lib
    return _idt_lib
