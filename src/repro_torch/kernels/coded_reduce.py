"""coded_reduce: out = Σ_p w[p]·g[p] over a (P, D) row stack, f32 sums.

The port of ``src/repro/kernels/coded_reduce.py:coded_reduce_pallas``.  On a
CUDA tensor :func:`coded_reduce` launches the hand-written sm_90a kernel in
``csrc/coded_reduce.cu`` (header there: design, and why it is memory-bound);
on a CPU tensor it runs :func:`coded_reduce_torch`, the plain PyTorch
version of the same function.  There is no fallback between the two: a
CUDA tensor launches the kernel or raises.

The kernel is built at first use with ``nvcc`` into
``build/repro_torch_kernels/`` at the repository root, keyed by a hash of
the source and flags, and bound with ``ctypes`` through a plain C
interface.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = [
    "coded_reduce",
    "coded_reduce_torch",
    "build_coded_reduce",
    "BUILD_INFO",
]

_SRC = Path(__file__).resolve().parent / "csrc" / "coded_reduce.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# dtype codes of the C interface (csrc/coded_reduce.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_DTYPES = {
    torch.float32: (torch.float32,),
    torch.bfloat16: (torch.bfloat16, torch.float32),
    torch.int8: (torch.float32,),
}

_lib = None
_lib_lock = threading.Lock()
# filled by the first build in this process: path, seconds, nvcc's -Xptxas -v
# report (registers, spills), or cached=True when an earlier build was reused
BUILD_INFO: dict = {}


def coded_reduce_torch(
    g: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """The plain version: (P, D), (P,) -> (D,) in f32, cast to ``out_dtype``
    (default ``g.dtype``)."""
    out_dtype = g.dtype if out_dtype is None else out_dtype
    return (w.float()[:, None] * g.float()).sum(0).to(out_dtype)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build coded_reduce")


def build_coded_reduce() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = _SRC.read_bytes()
        key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = _BUILD_DIR
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"coded_reduce_{key}.so"
        report = so.with_suffix(".ptxas.txt")  # nvcc's -Xptxas -v output
        if so.exists():
            ptxas = report.read_text() if report.exists() else ""
            BUILD_INFO.update(path=str(so), seconds=0.0, ptxas=ptxas, cached=True)
        else:
            tmp = out_dir / f".coded_reduce_{key}.{os.getpid()}.so"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {_SRC}:\n{proc.stderr}"
                )
            report.write_text(proc.stderr)
            os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
            BUILD_INFO.update(
                path=str(so), seconds=time.perf_counter() - t0,
                ptxas=proc.stderr, cached=False,
            )
        lib = ctypes.CDLL(str(so))
        lib.coded_reduce_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.coded_reduce_launch.restype = ctypes.c_int
        lib.coded_reduce_max_rows.argtypes = []
        lib.coded_reduce_max_rows.restype = ctypes.c_int
        _lib = lib
        return lib


def _launch(g: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    lib = build_coded_reduce()
    P, D = g.shape
    if P > lib.coded_reduce_max_rows():
        raise ValueError(f"coded_reduce takes at most {lib.coded_reduce_max_rows()} rows, got {P}")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.coded_reduce_launch(
            g.data_ptr(), w.data_ptr(), out.data_ptr(), P, D,
            _CODES[g.dtype], _CODES[out.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"coded_reduce launch failed: cudaError_t {err}")
    coded_reduce.launches += 1


def coded_reduce(
    g: torch.Tensor,
    w: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """g: (P, D) f32/bf16/int8; w: (P,) f32 -> (D,) = Σ_p w[p]·g[p].

    ``out_dtype`` defaults to ``g.dtype`` and may be f32 or the input type
    (int8 input: f32 only).  ``out`` is an optional (D,) result buffer.  A
    CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (counted in ``coded_reduce.launches``) or raises."""
    if g.dim() != 2 or w.dim() != 1 or w.shape[0] != g.shape[0]:
        raise ValueError(f"need g (P, D) and w (P,), got {tuple(g.shape)} and {tuple(w.shape)}")
    P, D = g.shape
    if P < 1 or D < 1:
        raise ValueError(f"empty reduction: g {tuple(g.shape)}")
    if g.dtype not in _OUT_DTYPES:
        raise TypeError(f"g dtype {g.dtype} not in {list(_OUT_DTYPES)}")
    if out is not None:
        out_dtype = out.dtype if out_dtype is None else out_dtype
    out_dtype = g.dtype if out_dtype is None else out_dtype
    if out_dtype not in _OUT_DTYPES[g.dtype]:
        raise TypeError(f"out dtype {out_dtype} not allowed for {g.dtype} input")
    if w.device != g.device or (out is not None and out.device != g.device):
        raise ValueError("g, w and out must be on one device")
    if out is not None and (
        out.shape != (D,) or out.dtype != out_dtype or not out.is_contiguous()
    ):
        raise ValueError(f"out must be a contiguous ({D},) {out_dtype} tensor")
    if g.device.type == "cpu":
        res = coded_reduce_torch(g, w, out_dtype)
        if out is None:
            return res
        return out.copy_(res)
    if g.device.type != "cuda":
        raise ValueError(f"coded_reduce runs on cpu or cuda tensors, not {g.device}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if not (g.is_contiguous() and w.is_contiguous()):
        raise ValueError("g and w must be contiguous")
    if out is None:
        out = torch.empty((D,), dtype=out_dtype, device=g.device)
    _launch(g, w, out)
    return out


coded_reduce.launches = 0  # kernel launches; the plain CPU version never counts
