"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for sm_90a into a shared
library of its own with a plain C interface, at first use, into
``build/repro_torch_kernels/`` at the repository root.  The nvcc processes
are started together and run in parallel.  Each library's name carries a
hash of every source in ``csrc/`` (headers included) and of the flags, so
an edit to any of them rebuilds all, and a finished build is reused by
later processes.  Processes that start together on a cold build
directory (the ranks of one ``torch.distributed.run``) take an exclusive
``flock`` on ``build/repro_torch_kernels/.lock`` around the build, so one
of them runs ``nvcc`` for each source and the others find its libraries;
the kernel closes the lock with the process, so a killed build leaves none
behind.  The libraries are loaded with ``ctypes``; each kernel module binds
its own functions' signatures.  No source includes PyTorch's headers, so a
build takes seconds.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_INFO", "build_all", "library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# no --use_fast_math: the int8 wire encode's bit contract needs IEEE
# division (-prec-div=true, nvcc's default) and no flush to zero
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# filled by the first build in this process: the build directory, the
# source hash, wall seconds of the (parallel) build, cached=True when every
# library was reused, and per source its library path and nvcc's
# -Xptxas -v report (registers, spills)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build the CUDA kernels")


def _sources_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _process_lock():
    """Exclusive across the processes of this host, released on exit."""
    with open(_BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile what is not built yet (in parallel) and load every kernel
    library, keyed by source stem (``"coded_reduce"``, ``"wire_encode"``)."""
    with _lock:
        if _libs:
            return _libs
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with _process_lock():
            return _build_locked()


def _build_locked() -> dict[str, ctypes.CDLL]:
    key = _sources_key()
    t0 = time.perf_counter()
    sources: dict[str, dict] = {}
    running: dict[str, tuple[subprocess.Popen, Path, Path, Path]] = {}
    try:
        for src in sorted(_CSRC.glob("*.cu")):
            so = _BUILD_DIR / f"{src.stem}_{key}.so"
            report = so.with_suffix(".ptxas.txt")
            if so.exists():
                ptxas = report.read_text() if report.exists() else ""
                sources[src.stem] = dict(path=str(so), ptxas=ptxas, cached=True)
                continue
            tmp = _BUILD_DIR / f".{src.stem}_{key}.{os.getpid()}.so"
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            running[src.stem] = (proc, tmp, so, report)
        for stem, (proc, tmp, so, report) in running.items():
            _, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {_CSRC / stem}.cu:\n{stderr}"
                )
            report.write_text(stderr)
            os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
            sources[stem] = dict(path=str(so), ptxas=stderr, cached=False)
    finally:
        for proc, *_ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    libs = {stem: ctypes.CDLL(info["path"]) for stem, info in sources.items()}
    BUILD_INFO.update(
        dir=str(_BUILD_DIR), key=key, seconds=time.perf_counter() - t0,
        cached=not running, sources=sources,
    )
    _libs.update(libs)
    return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    libs = build_all()
    if name not in libs:
        raise KeyError(f"no kernel source csrc/{name}.cu (have {sorted(libs)})")
    return libs[name]
