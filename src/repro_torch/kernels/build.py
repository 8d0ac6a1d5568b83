"""Build the port's CUDA kernel with ``nvcc`` and load it with ctypes.

``csrc/dequant_matmul.cu`` compiles, at first use, into a shared library
with a plain C interface in ``kernels/build/`` (listed in ``.gitignore``);
the library's name carries a hash of its source, so an edited source is
rebuilt and a stale build is never loaded.  Nothing here runs when the
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def compile_source(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a current build exists.  Returns
    ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills),
    or "" when nothing was built."""
    out = _lib_path(name)
    if out.exists():
        return ""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    (BUILD / f"{name}.ptxas.txt").write_text(proc.stdout)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        compile_source(name)
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]
