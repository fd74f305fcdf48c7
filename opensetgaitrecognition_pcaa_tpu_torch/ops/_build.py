"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``<repo>/build/kernels/lib<name>_<hash>.so``, nvcc's output beside it
as ``lib<name>_<hash>.log``; the hash covers the source, every ``csrc/``
header it includes and the flags, so an edited source or header is rebuilt
and a stale library is never loaded. Nothing
here runs at import time: the CPU tests import every module on machines
without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence

_PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register and shared-memory report) per loaded library,
# read back from the log beside a library built by an earlier process
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels are built from csrc/ at first use"
        )
    return found


def source_digest(name: str, src_dir: Optional[Path] = None) -> str:
    """Hash of ``<src_dir>/<name>.cu``, of every header under ``src_dir``
    that it includes (directly or through another header, each once, in
    include order) and of the nvcc flags. ``src_dir`` defaults to
    ``SRC_DIR`` as it stands at the call, the directory ``load_library``
    compiles from."""
    if src_dir is None:
        src_dir = SRC_DIR
    files = []

    def visit(path: Path) -> None:
        if path in files:
            return
        files.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            dep = src_dir / inc
            if dep.is_file():
                visit(dep)

    visit(src_dir / f"{name}.cu")
    h = hashlib.sha256()
    for path in files:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = SRC_DIR / f"{name}.cu"
    so_path = BUILD_DIR / f"lib{name}_{source_digest(name, src.parent)}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n"
                    + BUILD_LOGS[name]
                )
            so_path.with_suffix(".log").write_text(BUILD_LOGS[name])
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    elif name not in BUILD_LOGS and so_path.with_suffix(".log").exists():
        BUILD_LOGS[name] = so_path.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(so_path))
    _LIBS[name] = lib
    return lib


def load_libraries(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """``load_library`` for several sources, their nvcc builds run at once."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load_library, names)))
