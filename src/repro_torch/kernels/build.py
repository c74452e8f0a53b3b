"""Build a CUDA source of ``repro_torch/csrc`` into a plain-C shared library.

One ``nvcc`` call per source, for ``sm_90a``, into ``build/repro_torch/`` at
the repository root (listed in ``.gitignore``). The library's file name
carries the source's hash, so an edited source rebuilds on first use and an
unchanged one loads the library built before. ``-Xptxas -v`` is always on;
its report (registers, shared memory, spills per kernel) is kept beside the
library as ``<name>.ptxas.txt``. No ``--use_fast_math``: the kernels rely on
IEEE division and rounding.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Tuple

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parents[1] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> (loaded library, build record)
_LOADED: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def build(name: str) -> Tuple[pathlib.Path, dict]:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists. Returns ``(library path, record)``; the record holds the
    compile seconds (0 when reused), whether it was built, and ptxas' report."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log = BUILD_DIR / f"lib{name}-{digest}.ptxas.txt"
    if lib.exists():
        report = log.read_text() if log.exists() else ""
        return lib, {"built": False, "seconds": 0.0, "ptxas": report}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, lib)
    return lib, {"built": True, "seconds": seconds, "ptxas": report}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name not in _LOADED:
        path, record = build(name)
        _LOADED[name] = (ctypes.CDLL(str(path)), record)
    return _LOADED[name][0]


def build_record(name: str) -> dict:
    """The build record of a library loaded in this process."""
    load(name)
    return _LOADED[name][1]
