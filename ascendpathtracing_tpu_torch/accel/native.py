"""ctypes bindings for the port's native (C++) host components.

Counterpart of ``ascendpathtracing_tpu/accel/native.py``: the binned-SAH
BVH builder (``native/bvh_builder.cpp``), the fused PPM decode + encode
(``native/ppm_codec.cpp``) and the OBJ loader (``native/obj_loader.cpp``),
the port's own copies of the JAX package's sources.

``g++`` (``$CXX`` if set) compiles the three sources at first use, with the
JAX package's Makefile flags, into one library under
``build/ascendpathtracing_tpu_torch/`` at the root of the checkout (a
directory ``.gitignore`` lists).  The library's file name carries a hash
of the sources, the flags and the compiler's target macros (so a copy
built for another CPU is not reused), the compiler's output goes to the
``.log`` beside it, and the library is written to a temporary name and
renamed into place, so processes that build at once each see a whole
file.  Nothing builds at import time.

:class:`NativeUnavailable` means the library could not be built or
loaded; callers in ``"auto"`` mode fall back to the NumPy or Python path
on that error only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ascendpathtracing_tpu_torch"
SOURCES = ("bvh_builder.cpp", "ppm_codec.cpp", "obj_loader.cpp")
#: The JAX package's ``native/Makefile`` flags, so both libraries build
#: the same tables on one machine.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _compiler() -> str:
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        raise NativeUnavailable("native build failed: no C++ compiler (g++ or $CXX) on PATH")
    return cxx


def library_path(cxx: str) -> Path:
    """The library's path for the current sources, flags and target."""
    try:
        target = subprocess.run(
            [cxx, *CXX_FLAGS, "-E", "-dM", "-x", "c++", os.devnull],
            capture_output=True, check=True, timeout=60,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailable(f"native build failed: {cxx} -E: {e}") from e
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(target)
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libaptnative-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the three sources unless the library for them exists;
    returns its path.  Raises NativeUnavailable if g++ is missing or
    fails."""
    cxx = _compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = [cxx, *CXX_FLAGS, "-shared", "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, check=False)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailable(f"native build failed: {e}") from e
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(
            f"native build failed with exit code {proc.returncode}:\n{proc.stderr[-3000:]}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeUnavailable(f"cannot load {path}: {e}") from e
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        lib.apt_build_bvh.restype = ctypes.c_int32
        lib.apt_build_bvh.argtypes = [
            fp,  # tri_verts [F, 3, 3]
            ctypes.c_int32,  # n_tris
            ctypes.c_int32,  # max_leaf
            ctypes.c_int32,  # n_bins
            fp,  # bmin
            fp,  # bmax
            ip,  # first
            ip,  # count
            ip,  # miss
            ip,  # tri_order
            ctypes.c_int32,  # max_nodes
        ]
        lib.apt_encode_ppm.restype = ctypes.c_int64
        lib.apt_encode_ppm.argtypes = [
            fp,  # planes [3, w*h*4*s]
            ctypes.c_int32,  # width
            ctypes.c_int32,  # height
            ctypes.c_int32,  # samples
            ctypes.c_char_p,  # out text buffer
            ctypes.c_int64,  # max_len
        ]
        lib.apt_obj_count.restype = ctypes.c_int32
        lib.apt_obj_count.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.apt_obj_load.restype = ctypes.c_int32
        lib.apt_obj_load.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_long,
            ctypes.c_long,
        ]
        _lib = lib
        return lib


def is_available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def build_bvh_native(vertices, faces, *, max_leaf: int = 4, n_bins: int = 16):
    """C++ binned-SAH builder; the same output contract as
    ``accel/bvh.build_bvh_numpy`` (a :class:`~ascendpathtracing_tpu_torch.accel.bvh.FlatBVH`)."""
    from ascendpathtracing_tpu_torch.accel.bvh import FlatBVH

    lib = _load()
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    f = faces.shape[0]
    tri_verts = np.ascontiguousarray(vertices[faces], np.float32)  # [F, 3, 3]

    max_nodes = max(2 * f, 16)
    bmin = np.empty((max_nodes, 3), np.float32)
    bmax = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    order = np.empty(max(f, 1), np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    m = lib.apt_build_bvh(
        tri_verts.ctypes.data_as(fp), f, max_leaf, n_bins,
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp),
        first.ctypes.data_as(ip), count.ctypes.data_as(ip), miss.ctypes.data_as(ip),
        order.ctypes.data_as(ip), max_nodes,
    )
    if m < 0:
        raise RuntimeError("apt_build_bvh: node buffer too small")
    return FlatBVH(
        bmin=bmin[:m].copy(),
        bmax=bmax[:m].copy(),
        first=first[:m].copy(),
        count=count[:m].copy(),
        miss=miss[:m].copy(),
        tri_order=order[:f].copy(),
        max_leaf=max_leaf,
    )


def encode_ppm_native(planes, width: int, height: int, samples: int) -> str:
    """Fused decode (sub-pixel averaging + flip + clip) and ASCII P3
    encode in C++, bit-exact with ``utils/io.decode_color`` +
    ``encode_ppm``.

    planes: float32 [3, width*height*4*samples] color planes.
    """
    lib = _load()
    planes = np.ascontiguousarray(planes, np.float32)
    n = width * height * 4 * samples
    if planes.shape != (3, n):
        raise ValueError(f"expected [3, {n}] planes, got {planes.shape}")
    # worst case: 4 chars a value + a newline a line + the header
    max_len = width * (height * 3 * 4 + 2) + 64
    buf = ctypes.create_string_buffer(max_len)
    written = lib.apt_encode_ppm(
        planes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        width, height, samples, buf, max_len,
    )
    if written < 0:
        raise RuntimeError("apt_encode_ppm: buffer too small")
    return buf.raw[:written].decode("ascii")


def load_obj_native(path):
    """C++ Wavefront-OBJ loader; the same (vertices [V,3] f64, faces [F,3]
    i64) contract and parse semantics as ``accel/meshes.load_obj``
    (two passes: count, then fill buffers allocated here)."""
    lib = _load()
    pathb = os.fsencode(path)
    nv = ctypes.c_long(0)
    nt = ctypes.c_long(0)
    rc = lib.apt_obj_count(pathb, ctypes.byref(nv), ctypes.byref(nt))
    if rc == 2:  # a malformed token: the Python parser's exception
        raise ValueError(f"malformed token in OBJ file {path!r}")
    if rc:
        raise RuntimeError(f"apt_obj_count failed for {path!r}")
    if nv.value == 0 or nt.value == 0:
        raise ValueError(f"no geometry in OBJ file {path!r}")
    verts = np.empty((nv.value, 3), np.float64)
    faces = np.empty((nt.value, 3), np.int64)
    rc = lib.apt_obj_load(
        pathb,
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        nv.value,
        nt.value,
    )
    if rc == 2:
        raise ValueError(f"malformed token in OBJ file {path!r}")
    if rc:
        # an IO error, or the file changed between the count and the load
        raise RuntimeError(f"apt_obj_load failed for {path!r}")
    if faces.min() < 0 or faces.max() >= nv.value:
        raise ValueError(f"face index out of range in {path!r}")
    return verts, faces
