"""Build, load and count the hand-written CUDA kernels.

The sources under ``csrc/`` compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, one ``nvcc`` process per source started together, then
one link.  It lands in ``_build/<hash of the sources>/``, which git ignores,
so a checkout builds its kernels from its own sources alone.

Every wrapper adds one to its entry in :data:`LAUNCHES` where it launches
its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "launch_counts",
    "build",
    "lib",
    "check",
    "stream",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_SOURCES = ("quant4bit.cu", "gemm4bit_paired.cu", "flash_cached.cu", "blockwise8.cu", "optim8bit.cu",
            "gemm4bit.cu", "flash_attention.cu")
_HEADERS = ("common.cuh", "quant_tile.cuh", "sm90.cuh")
_LIBNAME = "libbnb_torch_kernels.so"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # IEEE division and no flush-to-zero: the quantize codes must equal the
    # JAX package's bit for bit (no --use_fast_math anywhere).
    "-prec-div=true", "-ftz=false",
)

LAUNCHES: dict = {
    "quantize_4bit_codes": 0,
    "gemm_4bit_paired": 0,
    "dequantize_paired_fast": 0,
    "flash_attention_cached": 0,
    "gemm_4bit_paired_dq": 0,
    "dequantize_paired_fast_dq": 0,
    "quantize_blockwise8": 0,
    "dequantize_blockwise8": 0,
    "gemm_4bit_paired_nt": 0,
    "gemm_4bit_paired_nt_dq": 0,
    "optimizer_update_8bit": 0,
    "flash_attention_cached_int8": 0,
    "flash_attention_paged": 0,
    "flash_attention_paged_int8": 0,
    "optimizer_update_8bit_ademamix": 0,
    "gemm_4bit_fused": 0,
    "gemm_4bit_fused_dq": 0,
    "dequantize_4bit_2d": 0,
    "dequantize_4bit_2d_dq": 0,
    "gemm_4bit_nt_fused": 0,
    "flash_attention_combine": 0,
    "quantize_blockwise8_any": 0,
    "dequantize_blockwise8_any": 0,
    "flash_attention_causal_fwd": 0,
    "flash_attention_causal_bwd_dkv": 0,
    "flash_attention_causal_bwd_dkv_combine": 0,
    "flash_attention_causal_bwd_dq": 0,
    "flash_attention_causal_fwd_wide": 0,
    "flash_attention_causal_bwd_dkv_wide": 0,
    "flash_attention_causal_bwd_dq_wide": 0,
}

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return cand


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if this source hash has no library yet; return
    the library's path.  Compiles each source in its own ``nvcc`` process,
    all at once, then links them into one ``.so``."""
    out_dir = os.path.join(_BUILD, _source_hash())
    so = os.path.join(out_dir, _LIBNAME)
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=_BUILD)
    try:
        procs = []
        for name in _SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *_NVCC_FLAGS, "-I", _CSRC, "-c",
                   os.path.join(_CSRC, name), "-o", obj]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        objs = [os.path.join(tmp, n + ".o") for n in _SOURCES]
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", os.path.join(tmp, _LIBNAME), *objs]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout)
        os.makedirs(out_dir, exist_ok=True)
        os.replace(os.path.join(tmp, _LIBNAME), so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U64 = ctypes.c_ulonglong

_FLASH_FWD = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _I, _P]
_FLASH_DKV = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L,
              _F, _I, _P]
_FLASH_DQ = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P]

_SIGNATURES = {
    # x, u (or NULL), codes, absmax, n, blocksize, midpoints[15] (host), sorted code[16] (host),
    # order (rank -> bit-pattern nibbles), identity, x_kind, stream
    "bnb_quantize_4bit_codes": [_P, _P, _P, _P, _L, _I, _P, _P, _U64, _I, _I, _P],
    # A, P, absmax_t, part (scratch, or NULL), out, M, N, K, blocksize, k_per_split, splits,
    # tc (the tensor-core kernel), units[16] (host), a_kind, out_f32, stream
    "bnb_gemm_4bit_paired": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P],
    # P, absmax_t, W, N, K, blocksize, units[16] (host), out_kind, stream
    "bnb_dequantize_paired": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
    # q, k, v, k_scale (or NULL), v_scale (or NULL), lengths, out, part_acc, part_ml (or NULL), B,
    # KVH, GT, S, hd, T, window, scale, int8, split_len, nsplit, stream
    "bnb_flash_attention_cached": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                                   _I, _P],
    # q, pool_k, pool_v, k_scale (or NULL), v_scale (or NULL), tables, lengths, out, part_acc,
    # part_ml (or NULL), B, KVH, GT, MAXB, BS, hd, T, window, scale, int8, split_len, nsplit, stream
    "bnb_flash_attention_paged": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                  _I, _I, _I, _P],
    # part_acc, part_ml, out, rows, hd, nsplit, stream
    "bnb_flash_attention_combine": [_P, _P, _P, _I, _I, _I, _P],
    # A, P, codes_t, s2, offset, part (or NULL), out, M, N, K, blocksize, k_per_split, splits, tc,
    # units[16] (host), decode table (host), a_kind, out_f32, stream
    "bnb_gemm_4bit_paired_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P],
    # P, codes_t, s2, offset, W, N, K, blocksize, units[16] (host), decode table (host), out_kind,
    # stream
    "bnb_dequantize_paired_dq": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P],
    # x, u (or NULL), q, absmax, n, blocksize, tables (device), ncode, rank mode, nh (buckets a
    # sign), shift, lo, stream
    "bnb_quantize_blockwise8": [_P, _P, _P, _P, _L, _I, _P, _I, _I, _I, _I, _I, _P],
    # q, absmax, out, n, blocksize, tables (device), out_kind, stream
    "bnb_dequantize_blockwise8": [_P, _P, _P, _L, _I, _P, _I, _P],
    # the same, at any blocksize (the _any instances)
    "bnb_quantize_blockwise8_any": [_P, _P, _P, _P, _L, _I, _P, _I, _I, _I, _I, _I, _P],
    "bnb_dequantize_blockwise8_any": [_P, _P, _P, _L, _I, _P, _I, _P],
    # G, P, absmax_t, part (scratch, or NULL), out, M, N, K, blocksize, rows_per_split, splits,
    # tc (the tensor-core kernel), units[16] (host), g_kind, stream
    "bnb_gemm_4bit_paired_nt": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    # G, P, codes_t, s2, offset, part (or NULL), out, M, N, K, blocksize, rows_per_split, splits,
    # tc, units[16] (host), decode table (host), g_kind, stream
    "bnb_gemm_4bit_paired_nt_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    # leaves (device table), nleaves, total blocks, maps (device), scalars (host), rule, fixup, kind,
    # sms, stream
    "bnb_optimizer_update_8bit": [_P, _I, _L, _P, _P, _I, _I, _I, _I, _P],
    # A, B, absmax, part (or NULL), out, M, N, K, blocksize, k_per_split, splits, tc, code[16] (host),
    # a_kind, out_f32, stream
    "bnb_gemm_4bit_fused": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P],
    # A, B, codes, s2, offset, part (or NULL), out, M, N, K, blocksize, k_per_split, splits, tc,
    # code[16] (host), decode table (host), a_kind, out_f32, stream
    "bnb_gemm_4bit_fused_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P],
    # B, absmax, out, n, blocksize, code[16] (host), out_kind, stream
    "bnb_dequantize_4bit_2d": [_P, _P, _P, _L, _I, _P, _I, _P],
    # B, codes, s2, offset, out, n, blocksize, code[16] (host), decode table (host), out_kind, stream
    "bnb_dequantize_4bit_2d_dq": [_P, _P, _P, _P, _P, _L, _I, _P, _P, _I, _P],
    # G, B, absmax, part (scratch), out, M, N, K, blocksize, rows_per_split, splits, code[16] (host),
    # g_kind, stream
    "bnb_gemm_4bit_nt_fused": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    # q, k, v, o, m, l, B, T, H, KVH, hd, (batch, token) strides of q, k, v, scale, kind (_KIND), stream;
    # the _wide entries take the same arguments
    "bnb_flash_attention_causal_fwd": _FLASH_FWD,
    "bnb_flash_attention_causal_fwd_wide": _FLASH_FWD,
    # q, k, v, do, m, l, di, dk, dv, part_k, part_v (or NULL), items (device), n_items, B, T, H, KVH, hd,
    # (batch, token) strides of q, k, v, do, scale, kind, stream
    "bnb_flash_attention_causal_bwd_dkv": _FLASH_DKV,
    "bnb_flash_attention_causal_bwd_dkv_wide": _FLASH_DKV,
    # part_k, part_v, table (device), n_units, dk, dv, T, KVH, hd, kind, stream
    "bnb_flash_attention_causal_bwd_dkv_combine": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, do, m, l, di, dq, B, T, H, KVH, hd, (batch, token) strides of q, k, v, do, scale, kind, stream
    "bnb_flash_attention_causal_bwd_dq": _FLASH_DQ,
    "bnb_flash_attention_causal_bwd_dq_wide": _FLASH_DQ,
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


# csrc/sm90.cuh's kTmaError: an entry point returns it plus the CUresult of
# cuTensorMapEncodeTiled when a TMA tensor map cannot be encoded
TMA_ERROR = 10000


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error from its launch, or a
    failed tensor-map encoding."""
    if err >= TMA_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with CUresult {err - TMA_ERROR}")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def host_f32(values) -> ctypes.Array:
    return (ctypes.c_float * len(values))(*[float(v) for v in values])


def host_i32(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*[int(v) for v in values])
