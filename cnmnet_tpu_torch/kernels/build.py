"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/cnmnet_tpu_torch/<name>-<hash>.so``
under the repository root, where ``<hash>`` covers the source, the headers
beside it and the compiler flags, so an edited source builds anew and an
unchanged one is loaded as it is. Each library exposes a plain C interface
(pointers and the stream as ``void*``, sizes as ``int``) and every entry
returns ``cudaGetLastError()``.

Nothing is compiled at import time. The first launch builds what it needs;
``build_all`` builds every source at once, one ``nvcc`` process per source,
all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cnmnet_tpu_torch"
SOURCES = ("cost_volume", "depth_to_normal")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler, from ``PATH`` or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        f"nvcc was not found on PATH or at {DEFAULT_NVCC}: the CUDA "
        "kernels of cnmnet_tpu_torch are built from source at first use and "
        "need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    ``(process, tmp_path, final_path)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=SOURCES) -> dict[str, str]:
    """Build the named sources in parallel; returns each one's nvcc output
    (``-Xptxas -v``: registers, shared memory, spills), empty when the
    library was already built. Raises if any build fails."""
    started = {name: _start(name) for name in names}
    logs, failed = {}, []
    for name, job in started.items():
        if job is None:
            logs[name] = ""
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
