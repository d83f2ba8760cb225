"""The host quantizer: blockwise 4-bit and 8-bit quantization on the CPU in
C++ with OpenMP, loaded with ``ctypes``.

Counterpart of the JAX package's ``utils/native.py``.  Quantizing a
checkpoint of several GB at load time is host work, and this library does
it without the card: ``csrc/host_quant.cpp`` (a copy of the repository's
root ``csrc/host_quant.cpp``, so the installed package stands alone) is
compiled at first use with ``g++ -O3 -march=native -shared -fPIC``, with
``-fopenmp`` when the compiler takes it, into ``_build/host_<hash>/``,
which git ignores.  It is not one of the CUDA sources of ``ops/_lib.py``.

The functions take and return numpy arrays, and their codes and absmax are
bit for bit those of ``functional/fourbit.quantize_4bit`` and of kernel 1
on the card.  There is no quiet fallback: without a compiler
:func:`available` is False and every function raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from ..functional.codebooks import create_dynamic_map, get_4bit_code, quantize_tables

logger = logging.getLogger(__name__)

__all__ = ["available", "quantize_4bit_host", "quantize_blockwise_host", "dequantize_4bit_host"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "host_quant.cpp")
_BUILD = os.path.join(_PKG, "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def _compile(src: str, so: str) -> bool:
    """Build ``so`` from ``src`` with OpenMP, or without it where the
    compiler refuses ``-fopenmp``; write to a temporary name first, so
    processes that build at once never load a partial file."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    for omp in (("-fopenmp",), ()):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
        os.close(fd)
        cmd = ["g++", *_FLAGS, *omp, "-o", tmp, src]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            logger.info("host quantizer build failed (%s): %s", " ".join(cmd), e)
            os.unlink(tmp)
            continue
        os.replace(tmp, so)
        return True
    return False


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(_BUILD, f"host_{digest}", "libbnb_torch_host.so")
    if not os.path.exists(so) and not _compile(_SRC, so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        logger.info("host quantizer failed to load: %s", e)
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    lib.bnb_tpu_quantize_4bit_host.argtypes = [f32p, i64, f32p, i32p, i64, u8p, f32p]
    lib.bnb_tpu_quantize_blockwise_host.argtypes = [f32p, i64, f32p, i64, u8p, f32p]
    lib.bnb_tpu_dequantize_4bit_host.argtypes = [u8p, i64, f32p, f32p, i64, f32p]
    lib.bnb_tpu_num_threads.restype = ctypes.c_int
    return lib


def available() -> bool:
    """Whether the host library built (or was built before) and loads."""
    return _lib() is not None


def _require() -> ctypes.CDLL:
    lib = _lib()
    if lib is None:
        raise RuntimeError("the host quantizer is unavailable: g++ could not build csrc/host_quant.cpp")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def quantize_4bit_host(W: np.ndarray, blocksize: int = 64, quant_type: str = "nf4") -> Tuple[np.ndarray, np.ndarray]:
    """Quantize a weight (any float type, read as float32) on the host:
    ``(packed uint8 [n/2], absmax float32 [ceil(n / blocksize)])`` over the
    flat element order, high nibble first, bit for bit
    ``functional.quantize_4bit``'s flat layout."""
    lib = _require()
    x = np.ascontiguousarray(W, np.float32).reshape(-1)
    n = x.size
    if n % 2:
        raise ValueError("element count must be even")
    mids, order, _ = quantize_tables(quant_type, blocksize)
    mids = np.ascontiguousarray(mids, np.float32)
    order = np.ascontiguousarray(order, np.int32)
    packed = np.empty(n // 2, np.uint8)
    absmax = np.empty(-(-n // blocksize), np.float32)
    lib.bnb_tpu_quantize_4bit_host(_ptr(x, ctypes.c_float), n, _ptr(mids, ctypes.c_float),
                                   _ptr(order, ctypes.c_int32), blocksize, _ptr(packed, ctypes.c_uint8),
                                   _ptr(absmax, ctypes.c_float))
    return packed, absmax


def quantize_blockwise_host(x: np.ndarray, blocksize: int = 256,
                            code: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Blockwise 8-bit quantize on the host against a sorted 256-entry
    ``code`` (the signed dynamic map by default): ``(codes uint8 in x's
    shape, absmax float32 [ceil(n / blocksize)])``."""
    lib = _require()
    code = create_dynamic_map() if code is None else np.asarray(code, np.float32)
    xf = np.ascontiguousarray(x, np.float32).reshape(-1)
    mids = np.ascontiguousarray((code[:-1] + code[1:]) * np.float32(0.5), np.float32)
    q = np.empty(xf.size, np.uint8)
    absmax = np.empty(-(-xf.size // blocksize), np.float32)
    lib.bnb_tpu_quantize_blockwise_host(_ptr(xf, ctypes.c_float), xf.size, _ptr(mids, ctypes.c_float), blocksize,
                                        _ptr(q, ctypes.c_uint8), _ptr(absmax, ctypes.c_float))
    return q.reshape(np.shape(x)), absmax


def dequantize_4bit_host(packed: np.ndarray, absmax: np.ndarray, shape, blocksize: int = 64,
                         quant_type: str = "nf4") -> np.ndarray:
    """Inverse of :func:`quantize_4bit_host`: float32 ``code * absmax`` in
    ``shape``."""
    lib = _require()
    n = int(np.prod(shape))
    code = np.ascontiguousarray(get_4bit_code(quant_type, blocksize), np.float32)
    p = np.ascontiguousarray(packed, np.uint8).reshape(-1)
    am = np.ascontiguousarray(absmax, np.float32).reshape(-1)
    if p.size * 2 < n or am.size < -(-n // blocksize):
        raise ValueError(f"{p.size} payload bytes and {am.size} scales do not cover {n} elements")
    out = np.empty(n, np.float32)
    lib.bnb_tpu_dequantize_4bit_host(_ptr(p, ctypes.c_uint8), n, _ptr(code, ctypes.c_float),
                                     _ptr(am, ctypes.c_float), blocksize, _ptr(out, ctypes.c_float))
    return out.reshape(shape)
