"""Builds the CUDA sources in ``csrc/`` into one shared library and loads it.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper), and the objects are linked into
``build/repro_torch/<hash>/librepro_torch.so`` at the root of the checkout.
The hash covers the sources and the flags, so an edit rebuilds and an
unchanged tree reuses the library. The library has a plain C interface and
is loaded with ``ctypes``: no PyTorch headers are compiled, which keeps a
build to seconds.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0. Nothing
here catches a failed build or launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

__all__ = ["dtype_code", "build", "launch", "device_limits", "library_path", "build_seconds"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Storage type codes of csrc/common.cuh.
_DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C signature of every entry point: argument types, all returning int.
_SIGNATURES = {
    # a, b, c, dtype, out dtype, mb, m, k, n, stream
    "repro_batched_matmul": [_P, _P, _P, _I, _I, _L, _L, _L, _L, _P],
    # x, out, dtype, m, q, p, plane, coef (host), stream
    "repro_signed_sum": [_P, _P, _I, _L, _I, _I, _L, _P, _P],
    # x, out, dtype, divide, m, q, p, hr, hc, coef (host), stream
    "repro_strassen_level": [_P, _P, _I, _I, _L, _I, _I, _L, _L, _P, _P],
    # aq, bq, cq, dtype, out dtype, r, mb, m2, k2, n2, coefs (host), stream
    "repro_strassen1": [_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _P, _P],
    # x, w, out, dtype, w dtype, rows, d, eps, stream
    "repro_rmsnorm": [_P, _P, _P, _I, _I, _L, _L, _F, _P],
    # x, w, dy, dx, dw, partial, counts, dtype, w dtype, rows, d, groups, reducers, eps, stream
    "repro_rmsnorm_bwd": [_P] * 7 + [_I, _I, _L, _L, _L, _I, _F, _P],
    # q, k, v, out, lse (or null), dtype, b, hq, hkv, sq, sk, d, causal, window, scale, stream
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _L, _L, _L, _L, _L, _L, _I, _L, _F, _P],
    # q, k, v, o, dout, lse, stats, acc, dkv_acc, counts, dq, dk, dv, dtype, b, hq, hkv, sq, sk,
    # d, causal, window, scale, parts, stream
    "repro_flash_attention_bwd": [_P] * 13 + [_I] + [_L] * 6 + [_I, _L, _F, _I, _P],
    # dtype, d: shared memory a block of the backward kernel takes (no stream)
    "repro_flash_bwd_smem": [_I, _I],
    # wx, r, h0, c0, n0, m0, c, n, m, hs, pre, c_all, n_all, m_all (or four nulls), counters,
    # b, s, h, dh, blocks, tiles per block, resident, stream
    "repro_slstm_seq": [_P] * 15 + [_L] * 7 + [_P],
    # rt, pre, c_all, n_all, m_all, c0, n0, m0, dhs, dh, dc, dn, dm (final), dwx, dh0, dc0, dn0,
    # dm0, counters, ring, b, s, h, dh, blocks, tiles per block, resident, rows, stream
    "repro_slstm_seq_bwd": [_P] * 20 + [_L] * 8 + [_P],
    # device, SM count (out), shared memory a block may opt in to (out)
    "repro_device_limits": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
}

_lib: Optional[ctypes.CDLL] = None
_build_seconds: Optional[float] = None


def dtype_code(*tensors: torch.Tensor) -> int:
    """The kernels' code for the tensors' common dtype; TypeError unless fp32 or bf16."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= _DTYPE_CODES.keys():
        got = sorted(map(str, dtypes))
        raise TypeError(f"need matching float32 or bfloat16 tensors, got {got}")
    return _DTYPE_CODES[dtypes.pop()]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in (*cu, *cuh):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "librepro_torch.so"


def _compile(out: Path) -> None:
    """Compile each source in parallel, link, and move the library into place."""
    nvcc = _nvcc()
    cu, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *(str(o) for _s, o, _p in procs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out.parent / "build.log").write_text(log)
        os.replace(tmp_lib, out)  # atomic: a concurrent process never loads a partial file


def build() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if this tree's is missing."""
    global _lib, _build_seconds
    if _lib is None:
        t0 = time.perf_counter()
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _build_seconds = time.perf_counter() - t0
        _lib = lib
    return _lib


def build_seconds() -> Optional[float]:
    """Seconds the first :func:`build` took in this process (None before)."""
    return _build_seconds


def device_limits(device: torch.device) -> Tuple[int, int]:
    """(SM count, bytes of shared memory a block may opt in to) of ``device``."""
    lib = build()
    sms, smem = ctypes.c_int(), ctypes.c_int()
    index = device.index if device.index is not None else torch.cuda.current_device()
    err = lib.repro_device_limits(index, ctypes.byref(sms), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"repro_device_limits failed with CUDA error {err}")
    return sms.value, smem.value


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream; raise on error."""
    lib = build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        what = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name} failed with CUDA error {err} ({what})")
