"""Builds the port's CUDA sources at first use and loads them with ctypes.

``nvcc`` compiles ``csrc/<name>.cu`` into a shared library with a plain C
interface under ``build/ascendpathtracing_tpu_torch/`` at the root of
the checkout (a directory ``.gitignore`` lists).  The library's file name
carries a hash of every source in ``csrc/`` and of the flags, so an edit
rebuilds it and an unchanged tree reuses it.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ascendpathtracing_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # Parity: no a*b+c -> FMA contraction (and no --use_fast_math), or the
    # kernels stop being bitwise equal to the NumPy oracle and the plain
    # torch twins.  See the head of csrc/render_ref.cu.
    "-fmad=false",
    # Registers, shared memory and spills of every kernel, kept in the
    # build log beside the library.
    "--resource-usage",
)

#: Every library of ``csrc/`` (one ``.cu`` each).
LIBRARIES = ("render_ref", "render_pt", "wbvh", "mesh_pt", "segsum", "bvh", "ceiling")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default
    install prefix.  Raises RuntimeError when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(name: str) -> Path:
    """Compiles ``csrc/<name>.cu`` unless the library for the current
    sources exists; returns its path.  The nvcc output (with
    ``--resource-usage``) goes to the ``.log`` beside it."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def build_all(names) -> list[Path]:
    """Builds several libraries at once, one nvcc process each, all
    started together; returns their paths."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """Builds (if needed) and loads ``csrc/<name>.cu``; one handle per
    process."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(build(name)))
        return _LOADED[name]
