"""Build a CUDA source of ``repro_torch/csrc`` into a plain-C shared library.

One ``nvcc`` call per source (several sources build in parallel,
:func:`build_many`), for ``sm_90a``, into ``build/repro_torch/`` at
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


def _paths(name: str) -> Tuple[pathlib.Path, pathlib.Path, pathlib.Path]:
    """(source, library, ptxas report) of ``csrc/<name>.cu``; the library's
    name carries the hash of the source and the flags."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    return src, lib, BUILD_DIR / f"lib{name}-{digest}.ptxas.txt"


def build_many(names) -> Dict[str, Tuple[pathlib.Path, dict]]:
    """Compile every ``csrc/<name>.cu`` of ``names`` that has no library of
    the same source hash yet, one ``nvcc`` process per source, all started
    together. Returns ``{name: (library path, record)}``; a record holds the
    compile seconds (0 when reused), whether it was built, and ptxas' report."""
    out: Dict[str, Tuple[pathlib.Path, dict]] = {}
    running = {}
    for name in dict.fromkeys(names):
        src, lib, log = _paths(name)
        if lib.exists():
            report = log.read_text() if log.exists() else ""
            out[name] = (lib, {"built": False, "seconds": 0.0, "ptxas": report})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        running[name] = (proc, cmd, src, lib, log, tmp, time.perf_counter())
    failures = []
    for name, (proc, cmd, src, lib, log, tmp, t0) in running.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}) building {src}:\n"
                            f"{' '.join(cmd)}\n{stderr}")
            continue
        report = stdout + stderr
        log.write_text(report)
        os.replace(tmp, lib)
        out[name] = (lib, {"built": True, "seconds": seconds, "ptxas": report})
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def build(name: str) -> Tuple[pathlib.Path, dict]:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists. Returns ``(library path, record)``."""
    return build_many([name])[name]


def load_many(names) -> None:
    """Build (in parallel, where needed) and load every source of ``names``."""
    missing = [n for n in names if n not in _LOADED]
    for name, (path, record) in build_many(missing).items():
        _LOADED[name] = (ctypes.CDLL(str(path)), record)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    load_many([name])
    return _LOADED[name][0]


def build_record(name: str) -> dict:
    """The build record of a library loaded in this process."""
    load(name)
    return _LOADED[name][1]
