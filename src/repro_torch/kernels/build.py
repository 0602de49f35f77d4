"""Build a kernel suite's CUDA sources into one shared library, on first use.

``nvcc`` compiles every ``csrc/*.cu`` of a suite into ``build/<name>-<hash>.so``
at the repository root, where the hash covers the sources, the ``*.cuh``
headers beside them and the compiler flags, so an edited source never reuses
a stale library.  The library has a
plain C interface and is loaded with ``ctypes``; nothing here includes
PyTorch's headers, so a build takes seconds.  ``ptxas`` register and
shared-memory usage is kept beside the library (``<name>-<hash>.ptxas.txt``).

``nvcc`` is found through ``CUDA_HOME`` or ``PATH``.  A missing compiler
raises: a CUDA tensor never falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
# load() calls per suite that found nothing in ``_LOADED`` (built or loaded
# a library): a sanitizer audits them as compiles
MISSES: Dict[str, int] = {}


def suite_names() -> Sequence[str]:
    """Every kernel suite: the directories beside this file with CUDA
    sources."""
    here = Path(__file__).resolve().parent
    return sorted(p.parent.name for p in here.glob("*/csrc"))


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are built from source at first use")
    return found


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """The library's path; its hash covers the flags, the sources and the
    ``*.cuh`` headers beside them."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = {p for src in sources for p in src.parent.glob("*.cuh")}
    for src in sorted(set(sources) | headers):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build (if needed) and load the suite ``name``; cached per process."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    MISSES[name] = MISSES.get(name, 0) + 1
    out = library_path(name, sources)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             *[str(s) for s in sources]],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    lib = _LOADED[name] = ctypes.CDLL(str(out))
    return lib


def ptxas_report(name: str, sources: Sequence[Path]) -> str:
    """What ``ptxas -v`` said about the suite's kernels when it was built."""
    return library_path(name, sources).with_suffix(".ptxas.txt").read_text()
