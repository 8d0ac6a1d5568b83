"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library
with a plain C interface in ``kernels/build/`` (listed in ``.gitignore``);
the library's name carries a hash of its source, so an edited source is
rebuilt and a stale build is never loaded.  :func:`compile_all` starts
one ``nvcc`` per source, all at once.  Nothing here runs when the module
is imported.  :func:`cache_stats` counts the compiles and the loads
served from the cache (the telemetry's ``jit`` namespace).
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

SOURCES = ("dequant_matmul", "dequant_gemv", "dequant_grouped", "flash_attention",
           "ragged_attention", "ragged_mma")

_LIBS: Dict[str, ctypes.CDLL] = {}
_STATS = {"builds": 0, "hits": 0}  # nvcc runs, load() calls served from _LIBS


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


def _start(name: str):
    """Start ``nvcc`` on ``csrc/<name>.cu`` unless a current build exists;
    returns (process, temporary output) or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp = started
    report, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{report}")
    os.replace(tmp, _lib_path(name))
    (BUILD / f"{name}.ptxas.txt").write_text(report)
    _STATS["builds"] += 1
    return report


def compile_source(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a current build exists.  Returns
    ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills),
    or "" when nothing was built."""
    return _finish(name, _start(name))


def compile_all(names=SOURCES) -> Dict[str, str]:
    """Compile every source at once, one ``nvcc`` each; returns each
    one's report.  Waits for all of them before raising on a failure."""
    started = {n: _start(n) for n in names}
    reports, errors = {}, []
    for n, s in started.items():
        try:
            reports[n] = _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name in _LIBS:
        _STATS["hits"] += 1
    else:
        compile_source(name)
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def cache_stats() -> Dict[str, int]:
    """``builds``: the ``nvcc`` compiles this process ran; ``hits``: the
    :func:`load` calls served from the loaded libraries; ``entries``: the
    libraries loaded."""
    return {"builds": _STATS["builds"], "hits": _STATS["hits"],
            "entries": len(_LIBS)}
