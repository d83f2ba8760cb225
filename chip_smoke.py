#!/usr/bin/env python3
"""Chip check of bitsandbytes_tpu_torch on one NVIDIA GPU (written for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (every one asserts; any failure exits non-zero before the result):

1. Device: the card's name and power limit (nvidia-smi), TF32 off.
2. Build: compiles the CUDA kernels from ``bitsandbytes_tpu_torch/csrc``.
3. Kernels against their plain PyTorch versions on the card, at the main
   paths' shapes (Llama-3-8B geometry), with times, bytes and bounds; the
   sweep that chose ``functional/gemm.LARGE_M_THRESHOLD``; ragged shapes;
   the backward kernels 7 and 8 (3h), the fused 8-bit optimizer update,
   kernel 14 (3i), and the sweep that chose
   ``functional/gemm.BACKWARD_LARGE_M_THRESHOLD`` (3j); kernel 4's int8-KV
   mode and kernel 16 (paged, bf16 and int8) at block sizes 16-256, each
   paged result against kernel 4 on the same data (3k); kernels 9, 10 and 11
   on the K-adjacent layout of bf16 ``quant_storage`` and the sweep of their
   routes (3l); kernel 15, the 8-bit AdEMAMix update (3m).  Kernel 1's
   stochastic mode against its plain version on the same uniforms (3a);
   kernels 2, 3, 5 and 6 on f16 and f32 activations and kernels 7 and 8 on
   f16 g (3e); kernels 14 and 15 on bf16 and f16 parameters (3i, 3m);
   kernels 4 and 16 at head_dim 64, 128 and 256, bf16 and int8, paged
   against dense bit for bit and each twice, bit for bit (3c, 3k), and the
   split combine that follows them at decode.
4. The main paths at full width: Llama-3-8B, all 32 layers, random
   weights from a seed, quantized on the card, 8 requests of 128-token
   prompts, one prefill and 32 greedy decode steps.  First with NF4 (4a),
   then with the absmax double-quantized, ``compress_statistics=True``
   (4b); then the blockwise 8-bit round trip of an lm_head-sized tensor
   with ``nested=True`` (4c); then QLoRA training on 4b's model (4d):
   rank-64 adapters on all seven targets, ``adamw8bit``, 4 x 512 tokens,
   five ``lora_train_step`` calls; then the continuous-batching engine on
   4a's model (4e): int8 KV in a paged pool of three quarters of the dense
   size, 16 slots, 48 requests of 32-768 prompt tokens and 64 new tokens,
   every other one sampled; then the same engine with a bf16 pool (the
   default ``kv_dtype``), 16 requests, one of them run to ``max_len``; then
   4a's serving and 4d's training on weights stored as the FSDP-QLoRA
   recipe stores them (4f): bf16 ``quant_storage`` (the K-adjacent layout,
   kernels 9 and 10), double-quantized, trained with ``ademamix8bit``
   (kernel 15).  The kernels' launch counts are zeroed just before each path
   and read just after it.
5. Both serving paths at 2 layers on the card and on the CPU (plain
   versions): equal quantized bytes, logits within tolerance, top-5
   containment; then one QLoRA step of each at 2 layers, M = 16 (5b): the
   loss and adapter gradients against the CPU, and the card's optimizer
   step against the CPU's on the same gradients; then the engine at 2
   layers, dense and paged, bf16 and int8 KV (5c): its greedy streams
   teacher-forced through the CPU stay in the CPU's top-5, and a decode
   step's logits agree; then 4f at 2 layers (5d): prefill and two decode
   steps against the CPU, and one AdEMAMix QLoRA step at M = 16 (kernels 9,
   11 and 15); then entry points that once raised on the card, each through
   its kernels and against the CPU (5e): ``Linear4bit`` with f16 and f32
   ``compute_dtype``, ``adamw8bit`` and ``ademamix8bit`` over bf16
   parameters, ``prefill``/``decode_step`` at head_dim 64 (``tiny``) and 256
   (``gemma_7b`` at 2 layers), and ``quantize_4bit(generator=)``.
6. The card's name and power limit once more, one JSON line describing
   every ported kernel, then the result line.

Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): the least time the
# card could take for a kernel's work is bounded by these.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

TPU_KERNELS = {
    "quantize_4bit_codes": (
        "bitsandbytes_tpu/ops/pallas/quant4bit.py:157", "bitsandbytes_tpu_torch/csrc/quant4bit.cu"),
    "gemm_4bit_paired": (
        "bitsandbytes_tpu/ops/pallas/gemm4bit_paired.py:506",
        "bitsandbytes_tpu_torch/csrc/gemm4bit_paired.cu"),
    "dequantize_paired_fast": (
        "bitsandbytes_tpu/ops/pallas/gemm4bit_paired.py:944",
        "bitsandbytes_tpu_torch/csrc/gemm4bit_paired.cu"),
    "flash_attention_cached": (
        "bitsandbytes_tpu/ops/pallas/flash_cached.py:482",
        "bitsandbytes_tpu_torch/csrc/flash_cached.cu"),
    "gemm_4bit_paired_dq": (
        "bitsandbytes_tpu/ops/pallas/gemm4bit_paired.py:634",
        "bitsandbytes_tpu_torch/csrc/gemm4bit_paired.cu"),
    "dequantize_paired_fast_dq": (
        "bitsandbytes_tpu/ops/pallas/gemm4bit_paired.py:915",
        "bitsandbytes_tpu_torch/csrc/gemm4bit_paired.cu"),
    "quantize_blockwise8": (
        "bitsandbytes_tpu/ops/pallas/blockwise8.py:145", "bitsandbytes_tpu_torch/csrc/blockwise8.cu"),
    "dequantize_blockwise8": (
        "bitsandbytes_tpu/ops/pallas/blockwise8.py:124", "bitsandbytes_tpu_torch/csrc/blockwise8.cu"),
    "gemm_4bit_paired_nt": (
        "bitsandbytes_tpu/ops/pallas/gemm4bit_paired.py:771",
        "bitsandbytes_tpu_torch/csrc/gemm4bit_paired.cu"),
    "gemm_4bit_paired_nt_dq": (
        "bitsandbytes_tpu/ops/pallas/gemm4bit_paired.py:827",
        "bitsandbytes_tpu_torch/csrc/gemm4bit_paired.cu"),
    "optimizer_update_8bit": (
        "bitsandbytes_tpu/ops/pallas/optim8bit.py:251", "bitsandbytes_tpu_torch/csrc/optim8bit.cu"),
    "flash_attention_cached_int8": (
        "bitsandbytes_tpu/ops/pallas/flash_cached.py:482",
        "bitsandbytes_tpu_torch/csrc/flash_cached.cu"),
    "flash_attention_paged": (
        "bitsandbytes_tpu/ops/pallas/flash_cached.py:455",
        "bitsandbytes_tpu_torch/csrc/flash_cached.cu"),
    "flash_attention_paged_int8": (
        "bitsandbytes_tpu/ops/pallas/flash_cached.py:455",
        "bitsandbytes_tpu_torch/csrc/flash_cached.cu"),
    "gemm_4bit_fused": ("bitsandbytes_tpu/ops/pallas/gemm4bit.py:265", "bitsandbytes_tpu_torch/csrc/gemm4bit.cu"),
    "dequantize_4bit_2d": ("bitsandbytes_tpu/ops/pallas/gemm4bit.py:330", "bitsandbytes_tpu_torch/csrc/gemm4bit.cu"),
    "gemm_4bit_nt_fused": ("bitsandbytes_tpu/ops/pallas/gemm4bit.py:444", "bitsandbytes_tpu_torch/csrc/gemm4bit.cu"),
    "optimizer_update_8bit_ademamix": (
        "bitsandbytes_tpu/ops/pallas/optim8bit.py:323", "bitsandbytes_tpu_torch/csrc/optim8bit.cu"),
    # the split-KV combine of kernels 4 and 16: the TPU kernel carries m, l and
    # acc across its ordered S grid axis instead
    "flash_attention_combine": (
        "bitsandbytes_tpu/ops/pallas/flash_cached.py:482",
        "bitsandbytes_tpu_torch/csrc/flash_cached.cu"),
}

LORA_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")

# Llama-3-8B decode linears (N, K) after fusing q/k/v and gate/up
LINEARS = {"wqkv": (6144, 4096), "wo": (4096, 4096), "gate_up": (28672, 4096), "down": (4096, 14336)}


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from bitsandbytes_tpu_torch.functional import blockwise as FB
    from bitsandbytes_tpu_torch.functional import gemm as G
    from bitsandbytes_tpu_torch.functional.codebooks import create_dynamic_map, get_4bit_code
    from bitsandbytes_tpu_torch.functional.fourbit import payload_bytes
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor
    from bitsandbytes_tpu_torch.ops import build, launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.ops.blockwise8 import (
        dequantize_blockwise8,
        dequantize_blockwise8_plain,
        quantize_blockwise8,
        quantize_blockwise8_plain,
    )
    from bitsandbytes_tpu_torch.functional import fourbit as F4
    from bitsandbytes_tpu_torch.nn.modules import Linear4bit
    from bitsandbytes_tpu_torch.ops import flash_cached as FC
    from bitsandbytes_tpu_torch.ops.flash_cached import (
        GT_MAX,
        flash_attention_cached,
        flash_attention_cached_plain,
        flash_attention_combine,
        flash_attention_combine_plain,
        flash_attention_paged,
        flash_attention_paged_plain,
    )
    from bitsandbytes_tpu_torch.serving import ContinuousBatchingEngine
    from bitsandbytes_tpu_torch.serving import engine as E
    from bitsandbytes_tpu_torch import optim as O
    from bitsandbytes_tpu_torch.ops.gemm4bit_paired import (
        _units,
        _code_tuple,
        dequantize_paired_fast,
        dequantize_paired_fast_dq,
        dequantize_paired_fast_dq_plain,
        dequantize_paired_fast_plain,
        gemm_4bit_paired,
        gemm_4bit_paired_dq,
        gemm_4bit_paired_dq_plain,
        gemm_4bit_paired_nt,
        gemm_4bit_paired_nt_dq,
        gemm_4bit_paired_nt_dq_plain,
        gemm_4bit_paired_nt_plain,
        gemm_4bit_paired_plain,
    )
    from bitsandbytes_tpu_torch.ops.optim8bit import (
        StateCodes,
        UpdateScalars,
        optimizer_update_8bit_,
        optimizer_update_8bit_plain,
    )
    from bitsandbytes_tpu_torch.ops.gemm4bit import (
        dequantize_4bit_2d,
        dequantize_4bit_2d_plain,
        gemm_4bit_fused,
        gemm_4bit_fused_plain,
        gemm_4bit_nt_fused,
        gemm_4bit_nt_fused_plain,
    )
    from bitsandbytes_tpu_torch.ops.quant4bit import quantize_4bit_codes, quantize_4bit_codes_plain
    from bitsandbytes_tpu_torch.utils.benchmark import bandwidth_canary, cuda_time

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, card=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    so = build()
    emit("build", seconds=round(time.perf_counter() - t0, 3), library=os.path.relpath(so))
    canary = bandwidth_canary(1 << 30)
    canary_bs = canary["gb_s"] * 1e9
    emit("canary", **canary)

    gen = torch.Generator(device=dev).manual_seed(1234)
    report = {}

    def entry(name, ms, plain_ms, library_ms, nbytes, ops, peak_ops, err, **extra):
        b_ms, b_by = bound_ms(nbytes, ops, peak_ops)
        report[name] = {
            "name": name, "route": "cuda", "source": TPU_KERNELS[name][1],
            "replaces": TPU_KERNELS[name][0], "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "bytes": nbytes,
            "canary_bound_ms": nbytes / canary_bs * 1e3, "ok": True,
        }
        emit("kernel_check", **report[name], **extra)

    bs = 64
    code = get_4bit_code("nf4", bs)
    units = _units(_code_tuple(code))

    # -- 3a. kernel 1: quantize, on the gate_up weight --------------------
    N, K = LINEARS["gate_up"]
    W = torch.randn(N, K, generator=gen, device=dev).to(torch.bfloat16).to(torch.float32)
    W[0, :bs] = 0.0  # an all-zero block
    x = W.reshape(-1)
    for qt in ("nf4", "fp4"):
        qk, ak = quantize_4bit_codes(x, qt, bs)
        qp, ap_ = quantize_4bit_codes_plain(x, qt, bs)
        assert torch.equal(qk, qp), f"quantize codes differ ({qt})"
        assert torch.equal(ak.view(torch.int32), ap_.view(torch.int32)), f"absmax differs ({qt})"
    # the stochastic mode: the same uniforms give the plain version's codes
    u = torch.rand(x.numel(), generator=gen, device=dev)
    moved = {}
    for qt in ("nf4", "fp4"):
        qk, ak = quantize_4bit_codes(x, qt, bs, u)
        qp, ap_ = quantize_4bit_codes_plain(x, qt, bs, u)
        assert torch.equal(qk, qp) and torch.equal(ak.view(torch.int32), ap_.view(torch.int32)), \
            f"stochastic quantize codes differ ({qt})"
        moved[qt] = (qk != quantize_4bit_codes(x, qt, bs)[0]).float().mean().item()
        assert 0.1 < moved[qt] < 0.4, f"stochastic quantize moved {moved[qt]} of the codes ({qt})"
    n_el = N * K
    sto = {"ms": cuda_time(lambda: quantize_4bit_codes(x, "nf4", bs, u), flush_l2=True)["median"],
           "plain_ms": cuda_time(lambda: quantize_4bit_codes_plain(x, "nf4", bs, u), n=5)["median"],
           "bytes": n_el * 8 + n_el + n_el // bs * 4, "moved_share": moved}
    sto["bound_ms"] = bound_ms(sto["bytes"], 28 * n_el, PEAK_F32_FLOPS)[0]
    entry(
        "quantize_4bit_codes",
        cuda_time(lambda: quantize_4bit_codes(x, "nf4", bs), flush_l2=True)["median"],
        cuda_time(lambda: quantize_4bit_codes_plain(x, "nf4", bs), n=5)["median"],
        None, n_el * 4 + n_el + n_el // bs * 4, 20 * n_el, PEAK_F32_FLOPS, 0.0,
        shape=[N, K], stochastic_u=sto,
    )
    del W, x, qk, ak, qp, ap_, u

    # -- 3b. kernel 2 (decode GEMM, M = 8) and kernel 3 (dequantize) ------
    weights = {}
    for name, (N, K) in LINEARS.items():
        Wf = torch.randn(N, K, generator=gen, device=dev) * K**-0.5
        weights[name] = QuantizedTensor.quantize(Wf, blocksize=bs)
        assert weights[name].state.layout == "paired"
    M = 8
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0, "ops": 0, "err": 0.0}
    per_shape = []
    a_modes = {"float16": 0.0, "float32": 0.0}  # one layer's 4 linears at M 8, A in that type
    for name, (N, K) in LINEARS.items():
        qt = weights[name]
        P, am_t = qt.data, qt.state.absmax
        A = (torch.randn(M, K, generator=gen, device=dev)).to(torch.bfloat16)
        out = gemm_4bit_paired(A, P, am_t, code, bs, (N, K), out_dtype=torch.float32)
        ref = gemm_4bit_paired_plain(A, P, am_t, units, bs)
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-3, f"gemm {name}: rel err {rel}"
        for dt in (torch.float16, torch.float32):
            Ad = A.to(dt)
            od = gemm_4bit_paired(Ad, P, am_t, code, bs, (N, K))
            rd = gemm_4bit_paired_plain(Ad, P, am_t, units, bs)
            assert od.dtype == dt and ((od.float() - rd).abs().max() / rd.abs().max()).item() <= 1e-3, \
                f"gemm {name} {dt}"
            a_modes[str(dt)[6:]] += cuda_time(lambda: gemm_4bit_paired(Ad, P, am_t, code, bs, (N, K)),
                                              flush_l2=True)["median"]
        out_bf = gemm_4bit_paired(A, P, am_t, code, bs, (N, K))
        assert torch.equal(out_bf, out.to(torch.bfloat16)), f"gemm {name}: bf16 output"
        Wb = dequantize_paired_fast_plain(P, am_t, units, bs, torch.bfloat16)
        ms = cuda_time(lambda: gemm_4bit_paired(A, P, am_t, code, bs, (N, K)), flush_l2=True)["median"]
        pms = cuda_time(lambda: gemm_4bit_paired_plain(A, P, am_t, units, bs), n=5)["median"]
        lms = cuda_time(lambda: torch.matmul(A, Wb.t()), flush_l2=True)["median"]
        nbytes = M * K * 2 + N * K // 2 + (K // bs) * N * 4 + M * N * 2
        per_shape.append({"linear": name, "N": N, "K": K, "M": M, "ms": ms, "plain_ms": pms,
                          "library_ms": lms, "bytes": nbytes,
                          "bound_ms": bound_ms(nbytes, 2 * M * N * K, PEAK_BF16_FLOPS)[0],
                          "rel_err": rel})
        tot["ms"] += ms
        tot["plain"] += pms
        tot["lib"] += lms
        tot["bytes"] += nbytes
        tot["ops"] += 2 * M * N * K
        tot["err"] = max(tot["err"], (out - ref).abs().max().item())
        del Wb
    entry("gemm_4bit_paired", tot["ms"], tot["plain"], tot["lib"], tot["bytes"], tot["ops"],
          PEAK_BF16_FLOPS, tot["err"], per_shape=per_shape, a_dtype_ms=a_modes,
          note="sum over one layer's 4 linears at M=8; a_dtype_ms: the same with f16 and f32 A")

    N, K = LINEARS["gate_up"]
    P, am_t = weights["gate_up"].data, weights["gate_up"].state.absmax
    Wk = dequantize_paired_fast(P, am_t, code, bs)
    Wp = dequantize_paired_fast_plain(P, am_t, units, bs, torch.bfloat16)
    assert torch.equal(Wk.view(torch.int16), Wp.view(torch.int16)), "dequantize differs"
    out_modes = {}
    for dt in (torch.float16, torch.float32):
        Wk = dequantize_paired_fast(P, am_t, code, bs, dt)
        assert Wk.dtype == dt and torch.equal(Wk, dequantize_paired_fast_plain(P, am_t, units, bs, dt)), \
            f"dequantize differs ({dt})"
        out_modes[str(dt)[6:]] = cuda_time(lambda: dequantize_paired_fast(P, am_t, code, bs, dt),
                                           flush_l2=True)["median"]
    del Wk, Wp
    entry(
        "dequantize_paired_fast",
        cuda_time(lambda: dequantize_paired_fast(P, am_t, code, bs), flush_l2=True)["median"],
        cuda_time(lambda: dequantize_paired_fast_plain(P, am_t, units, bs, torch.bfloat16), n=5)["median"],
        None, N * K // 2 + (K // bs) * N * 4 + N * K * 2, N * K, PEAK_F32_FLOPS, 0.0, shape=[N, K],
        out_dtype_ms=out_modes,
    )

    # -- 3c. kernel 4: flash attention, decode and a prefill chunk --------
    cfg = L.LlamaConfig.llama3_8b()
    KVH, hd = cfg.num_kv_heads, cfg.head_dim
    Gq = cfg.num_heads // KVH
    B, S = 8, 1024
    kc = torch.randn(B, KVH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(B, KVH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    import torch.nn.functional as F

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def flash_case(T, lengths, kc=kc, vc=vc):
        hd = kc.shape[-1]
        q = torch.randn(B, KVH, Gq * T, hd, generator=gen, device=dev).to(torch.bfloat16)
        out = flash_attention_cached(q, kc, vc, lengths, T=T)
        ref = flash_attention_cached_plain(q, kc, vc, lengths, T, None, torch.bfloat16)
        assert torch.allclose(out.float(), ref.float(), atol=0.02, rtol=0.02), f"flash T={T} hd {hd}"
        assert torch.equal(out.view(torch.int16), flash_attention_cached(q, kc, vc, lengths, T=T).view(torch.int16)), \
            f"flash T={T} hd {hd}: differs from run to run"
        err = (out.float() - ref.float()).abs().max().item()
        # SDPA yardstick: heads h = kvh*G + g, as the fold's rows r = g*T + t
        q4 = q.reshape(B, KVH * Gq, T, hd)
        q_pos = lengths[:, None] - (T - 1) + torch.arange(T, device=dev)[None, :]
        mask = (torch.arange(S, device=dev)[None, None, :] <= q_pos[:, :, None])[:, None]
        sdpa = F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask, enable_gqa=True)
        assert torch.allclose(sdpa.float(), out.reshape(B, KVH * Gq, T, hd).float(), atol=0.05, rtol=0.05)
        live = (lengths.clamp(max=S - 1) + 1).sum().item()  # positions read per kv head
        nbytes = 2 * q.numel() * 2 + live * KVH * hd * 2 * 2 + B * 4
        ops = 4 * hd * Gq * T * live * KVH  # qk and pv, every row over its slot's live span
        return {
            "ms": cuda_time(lambda: flash_attention_cached(q, kc, vc, lengths, T=T), flush_l2=True)["median"],
            "plain_ms": cuda_time(
                lambda: flash_attention_cached_plain(q, kc, vc, lengths, T, None, torch.bfloat16), n=5
            )["median"],
            "library_ms": cuda_time(
                lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask, enable_gqa=True),
                flush_l2=True,
            )["median"],
            # the same two with the host's enqueue kept out of the window (cuda_time's hold)
            "device_ms": cuda_time(lambda: flash_attention_cached(q, kc, vc, lengths, T=T), flush_l2=True,
                                   hold=True)["median"],
            "library_device_ms": cuda_time(
                lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask, enable_gqa=True),
                flush_l2=True, hold=True,
            )["median"],
            "bytes": nbytes, "ops": ops, "err": err, "splits": FC.flash_splits(B * KVH, Gq * T, S, sms),
        }

    dec_len = torch.randint(128, S, (B,), generator=gen, device=dev, dtype=torch.int32)
    dec = flash_case(1, dec_len)
    pre = flash_case(128, torch.full((B,), 255, dtype=torch.int32, device=dev))
    pre_bound = bound_ms(pre["bytes"], pre["ops"], PEAK_BF16_FLOPS)
    other_hd = {}  # the decode geometry at head_dim 64 and 256
    for hd_x in (64, 256):
        kx, vx = (torch.randn(B, KVH, S, hd_x, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        r = flash_case(1, dec_len, kx, vx)
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"], PEAK_BF16_FLOPS)
        other_hd[hd_x] = r
        del kx, vx
    entry("flash_attention_cached", dec["ms"], dec["plain_ms"], dec["library_ms"], dec["bytes"],
          dec["ops"], PEAK_BF16_FLOPS, max(dec["err"], pre["err"]),
          decode={"B": B, "S": S, "T": 1, "lengths": dec_len.tolist(), "splits": dec["splits"]},
          prefill_chunk={"B": B, "S": S, "T": 128, "length": 255, "ms": pre["ms"],
                         "plain_ms": pre["plain_ms"], "library_ms": pre["library_ms"],
                         "device_ms": pre["device_ms"], "library_device_ms": pre["library_device_ms"],
                         "bytes": pre["bytes"], "bound_ms": pre_bound[0], "bound_by": pre_bound[1],
                         "splits": pre["splits"]},
          device_ms=dec["device_ms"], library_device_ms=dec["library_device_ms"],
          decode_head_dim={str(k): v for k, v in other_hd.items()}, run_to_run_bit_identical=True)

    # the split combine after a decode call at this geometry, on partials of its shape
    split_len, nsplit = dec["splits"]
    rows = B * KVH * Gq
    part_acc = torch.randn(nsplit, rows, hd, generator=gen, device=dev)
    part_ml = torch.stack([torch.randn(nsplit, rows, generator=gen, device=dev) * 3,
                           torch.rand(nsplit, rows, generator=gen, device=dev) * 40 + 1], -1)
    part_ml[1:, :8, 0] = -1e30  # rows whose later splits hold no live position
    part_ml[1:, :8, 1] = 0.0
    ck = flash_attention_combine(part_acc, part_ml)
    cp = flash_attention_combine_plain(part_acc, part_ml)
    err_c = (ck.float() - cp.float()).abs().max().item()
    assert torch.allclose(ck.float(), cp.float(), atol=1e-2, rtol=1e-2), f"combine: max abs err {err_c}"
    assert torch.equal(ck.view(torch.int16), flash_attention_combine(part_acc, part_ml).view(torch.int16))
    entry("flash_attention_combine",
          cuda_time(lambda: flash_attention_combine(part_acc, part_ml), flush_l2=True)["median"],
          cuda_time(lambda: flash_attention_combine_plain(part_acc, part_ml), n=5)["median"], None,
          nsplit * rows * (hd + 2) * 4 + rows * hd * 2, 4 * nsplit * rows * hd, PEAK_F32_FLOPS, err_c,
          splits=nsplit, split_len=split_len, rows=rows, hd=hd,
          device_ms=cuda_time(lambda: flash_attention_combine(part_acc, part_ml), flush_l2=True, hold=True)["median"],
          note="the split-KV combine at the decode geometry above (B 8, KVH 8, G 4, S 1024); library_ms "
               "null: no single PyTorch call computes it")
    del kc, vc, part_acc, part_ml

    # -- 3d. the large-M threshold: kernel 2 against kernel 3 + matmul ----
    sweep = []
    for name in ("gate_up", "down"):
        N, K = LINEARS[name]
        P, am_t = weights[name].data, weights[name].state.absmax
        for Mx in (16, 32, 64, 256, 1024):
            A = torch.randn(Mx, K, generator=gen, device=dev).to(torch.bfloat16)
            k2 = cuda_time(lambda: gemm_4bit_paired(A, P, am_t, code, bs, (N, K)), n=10, flush_l2=True)
            k3 = cuda_time(
                lambda: torch.matmul(A, dequantize_paired_fast(P, am_t, code, bs).t()), n=10, flush_l2=True
            )
            sweep.append({"linear": name, "M": Mx, "gemm_kernel_ms": k2["median"],
                          "dequant_matmul_ms": k3["median"]})
    emit("threshold_sweep", LARGE_M_THRESHOLD=G.LARGE_M_THRESHOLD, points=sweep)
    del weights
    torch.cuda.empty_cache()

    # -- 3e. ragged shapes: partial tiles, odd counts, other codebooks ----
    cases = []
    for qt, qbs, n in (("fp4", 32, 32 * 7), ("int4", 128, 128 * 5), ("af4", 64, 64 * 3), ("nf4", 4096, 8192)):
        xq = torch.randn(n, generator=gen, device=dev)
        assert all(torch.equal(a, b) for a, b in zip(
            quantize_4bit_codes(xq, qt, qbs), quantize_4bit_codes_plain(xq, qt, qbs))), f"quantize {qt}/{qbs}"
        cases.append(f"quantize {qt} bs{qbs} n{n}")
    for Mx, N, K, gbs in ((1, 2, 32, 32), (3, 18, 96, 32), (13, 130, 4160, 64), (31, 256, 2176, 128),
                          (5, 64, 8192, 4096)):
        qw = QuantizedTensor.quantize(torch.randn(N, K, generator=gen, device=dev), blocksize=gbs)
        P, am_t = qw.data, qw.state.absmax
        A = torch.randn(Mx, K, generator=gen, device=dev).to(torch.bfloat16)
        out = gemm_4bit_paired(A, P, am_t, code, gbs, (N, K), out_dtype=torch.float32)
        ref = gemm_4bit_paired_plain(A, P, am_t, units, gbs)
        assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-3, f"gemm {(Mx, N, K, gbs)}"
        Wk = dequantize_paired_fast(P, am_t, code, gbs)
        assert torch.equal(Wk, dequantize_paired_fast_plain(P, am_t, units, gbs, torch.bfloat16)), (N, K, gbs)
        for dt in (torch.float16, torch.float32):  # f16 and f32 activations, and the weight in their type
            Ad = A.to(dt)
            od = gemm_4bit_paired(Ad, P, am_t, code, gbs, (N, K))
            rd = gemm_4bit_paired_plain(Ad, P, am_t, units, gbs)
            assert od.dtype == dt and ((od.float() - rd).abs().max() / rd.abs().max()).item() <= 1e-3, \
                f"gemm {(Mx, N, K, gbs)} {dt}"
            assert torch.equal(dequantize_paired_fast(P, am_t, code, gbs, dt),
                               dequantize_paired_fast_plain(P, am_t, units, gbs, dt)), f"dequant {(N, K, gbs)} {dt}"
        cases.append(f"gemm+dequant M{Mx} N{N} K{K} bs{gbs} bf16/f16/f32")
    for Bx, H, Gx, T, Sx, lens, win in ((1, 1, 1, 1, 1, [0], None), (3, 2, 3, 5, 100, [4, 50, 99], None),
                                        (2, 2, 4, 3, 200, [150, 199], 16), (2, 1, 7, 1, 70, [69, 0], None),
                                        (1, 1, 2, 64, 300, [299], None), (2, 1, 4, 3, 64, [1, 40], None)):
        qx = torch.randn(Bx, H, Gx * T, hd, generator=gen, device=dev).to(torch.bfloat16)
        kx, vx = (torch.randn(Bx, H, Sx, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        lx = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = flash_attention_cached(qx, kx, vx, lx, T=T, window=win)
        ref = flash_attention_cached_plain(qx, kx, vx, lx, T, win, torch.bfloat16)
        assert torch.allclose(out.float(), ref.float(), atol=0.02, rtol=0.02), f"flash {(Bx, H, Gx, T, Sx, lens, win)}"
        cases.append(f"flash B{Bx} KVH{H} G{Gx} T{T} S{Sx} window{win}")
    emit("ragged_shapes", passed=cases)

    # -- 3f. kernels 5/6 (nested absmax) and 12/13 (blockwise 8-bit) -------
    dyn = create_dynamic_map()
    dyn_t = tuple(float(v) for v in dyn)
    nested = {}
    for name, (N, K) in LINEARS.items():
        Wf = torch.randn(N, K, generator=gen, device=dev) * K**-0.5
        nested[name] = QuantizedTensor.quantize(Wf, blocksize=bs, compress_statistics=True)
        assert nested[name].state.inline_nested
        del Wf
    M = 8
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "k2": 0.0, "bytes": 0, "ops": 0, "err": 0.0}
    per_shape = []
    a_modes_dq = {"float16": 0.0, "float32": 0.0}
    for name, (N, K) in LINEARS.items():
        qt = nested[name]
        st = qt.state
        args = (qt.data, st.absmax, st.state2.absmax, st.offset)
        A = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        out = gemm_4bit_paired_dq(A, *args, code, bs, (N, K), out_dtype=torch.float32)
        ref = gemm_4bit_paired_dq_plain(A, *args, units, bs)
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-3, f"gemm_dq {name}: rel err {rel}"
        am_t = st.dequant_absmax_t()  # the resolved f32 scales: kernel 2 must give the same bits
        assert torch.equal(out, gemm_4bit_paired(A, qt.data, am_t, code, bs, (N, K), out_dtype=torch.float32)), \
            f"gemm_dq {name}: differs from kernel 2 on the resolved absmax"
        for dt in (torch.float16, torch.float32):
            Ad = A.to(dt)
            od = gemm_4bit_paired_dq(Ad, *args, code, bs, (N, K))
            assert od.dtype == dt and torch.equal(od, gemm_4bit_paired(Ad, qt.data, am_t, code, bs, (N, K))), \
                f"gemm_dq {name} {dt}: differs from kernel 2 on the resolved absmax"
            a_modes_dq[str(dt)[6:]] += cuda_time(lambda: gemm_4bit_paired_dq(Ad, *args, code, bs, (N, K)),
                                                 flush_l2=True)["median"]
        Wb = dequantize_paired_fast_dq_plain(*args, units, bs, torch.bfloat16)
        ms = cuda_time(lambda: gemm_4bit_paired_dq(A, *args, code, bs, (N, K)), flush_l2=True)["median"]
        k2 = cuda_time(lambda: gemm_4bit_paired(A, qt.data, am_t, code, bs, (N, K)), flush_l2=True)["median"]
        pms = cuda_time(lambda: gemm_4bit_paired_dq_plain(A, *args, units, bs), n=5)["median"]
        lms = cuda_time(lambda: torch.matmul(A, Wb.t()), flush_l2=True)["median"]
        nb2 = st.state2.absmax.numel()
        nbytes = M * K * 2 + N * K // 2 + (K // bs) * N + nb2 * 4 + 4 + M * N * 2
        per_shape.append({"linear": name, "N": N, "K": K, "M": M, "ms": ms, "kernel2_resolved_ms": k2,
                          "plain_ms": pms, "library_ms": lms, "bytes": nbytes,
                          "bound_ms": bound_ms(nbytes, 2 * M * N * K, PEAK_BF16_FLOPS)[0], "rel_err": rel})
        for key, v in (("ms", ms), ("plain", pms), ("lib", lms), ("k2", k2), ("bytes", nbytes),
                       ("ops", 2 * M * N * K)):
            tot[key] += v
        tot["err"] = max(tot["err"], (out - ref).abs().max().item())
        del Wb, am_t
    entry("gemm_4bit_paired_dq", tot["ms"], tot["plain"], tot["lib"], tot["bytes"], tot["ops"],
          PEAK_BF16_FLOPS, tot["err"], per_shape=per_shape, kernel2_resolved_ms=tot["k2"], a_dtype_ms=a_modes_dq,
          note="sum over one layer's 4 nested linears at M=8; kernel2_resolved_ms is kernel 2 on "
               "the same weights with the absmax decoded to f32, timed in the same run; a_dtype_ms: "
               "with f16 and f32 A")

    N, K = LINEARS["gate_up"]
    qt = nested["gate_up"]
    st = qt.state
    args = (qt.data, st.absmax, st.state2.absmax, st.offset)
    Wk = dequantize_paired_fast_dq(*args, code, bs)
    Wp = dequantize_paired_fast_dq_plain(*args, units, bs, torch.bfloat16)
    assert torch.equal(Wk.view(torch.int16), Wp.view(torch.int16)), "dequantize_dq differs"
    out_modes = {}
    for dt in (torch.float16, torch.float32):
        Wk = dequantize_paired_fast_dq(*args, code, bs, dt)
        assert Wk.dtype == dt and torch.equal(Wk, dequantize_paired_fast_dq_plain(*args, units, bs, dt)), \
            f"dequantize_dq differs ({dt})"
        out_modes[str(dt)[6:]] = cuda_time(lambda: dequantize_paired_fast_dq(*args, code, bs, dt),
                                           flush_l2=True)["median"]
    del Wk, Wp
    k3 = cuda_time(lambda: dequantize_paired_fast(qt.data, st.dequant_absmax_t(), code, bs),
                   flush_l2=True)["median"]
    entry(
        "dequantize_paired_fast_dq",
        cuda_time(lambda: dequantize_paired_fast_dq(*args, code, bs), flush_l2=True)["median"],
        cuda_time(lambda: dequantize_paired_fast_dq_plain(*args, units, bs, torch.bfloat16), n=5)["median"],
        None, N * K // 2 + (K // bs) * N + st.state2.absmax.numel() * 4 + 4 + N * K * 2, N * K,
        PEAK_F32_FLOPS, 0.0, shape=[N, K],
        kernel3_with_decode_ms=k3, out_dtype_ms=out_modes,
        note="kernel3_with_decode_ms: the nested absmax decoded by plain PyTorch ops, then kernel 3",
    )

    # kernel 13 at load: the nested absmax of gate_up (offset removed, blocksize 256)
    am = st.dequant_absmax()  # stands for the first-level absmax; only its shape and spread matter
    xa = (am - am.mean()).contiguous()
    qk, ak = quantize_blockwise8(xa, dyn, 256)
    qp, ap_ = quantize_blockwise8_plain(xa, dyn_t, 256)
    assert torch.equal(qk, qp) and torch.equal(ak, ap_), "quantize_blockwise8 differs (nested absmax)"
    n_a = xa.numel()
    q13 = {"shape": [n_a], "blocksize": 256,
           "ms": cuda_time(lambda: quantize_blockwise8(xa, dyn, 256), flush_l2=True)["median"],
           "plain_ms": cuda_time(lambda: quantize_blockwise8_plain(xa, dyn_t, 256), n=5)["median"],
           "bytes": n_a * 5 + n_a // 256 * 4}
    d12 = {"shape": [n_a], "blocksize": 256, "dtype": "float32",
           "ms": cuda_time(lambda: dequantize_blockwise8(qk, ak, dyn, 256), flush_l2=True)["median"],
           "plain_ms": cuda_time(lambda: dequantize_blockwise8_plain(qk, ak, dyn_t, 256, torch.float32),
                                 n=5)["median"],
           "bytes": n_a * 5 + n_a // 256 * 4}
    assert torch.equal(dequantize_blockwise8(qk, ak, dyn, 256),
                       dequantize_blockwise8_plain(qk, ak, dyn_t, 256, torch.float32)), "dequantize_blockwise8 differs"
    del nested, xa, am, qk, ak, qp, ap_
    torch.cuda.empty_cache()

    # kernels 12 and 13 on an lm_head-sized tensor [32000, 4096], blocksize 4096
    xl = torch.randn(32000 * 4096, generator=gen, device=dev)
    qk, ak = quantize_blockwise8(xl, dyn, 4096)
    qp, ap_ = quantize_blockwise8_plain(xl, dyn_t, 4096)
    assert torch.equal(qk, qp) and torch.equal(ak, ap_), "quantize_blockwise8 differs (lm_head)"
    del qp, ap_
    n_l = xl.numel()
    entry("quantize_blockwise8",
          q13["ms"], q13["plain_ms"], None, q13["bytes"], 16 * n_a, PEAK_F32_FLOPS, 0.0, **{
              "shape": q13["shape"], "blocksize": 256,
              "note": "the nested absmax of gate_up, as the double-quantized load quantizes it",
              "lm_head": {"shape": [32000, 4096], "blocksize": 4096,
                          "ms": cuda_time(lambda: quantize_blockwise8(xl, dyn, 4096), flush_l2=True)["median"],
                          "plain_ms": cuda_time(lambda: quantize_blockwise8_plain(xl, dyn_t, 4096), n=3)["median"],
                          "bytes": n_l * 5 + n_l // 4096 * 4,
                          "bound_ms": bound_ms(n_l * 5 + n_l // 4096 * 4, 16 * n_l, PEAK_F32_FLOPS)[0]}})
    dk = dequantize_blockwise8(qk, ak, dyn, 4096, torch.bfloat16)
    dp = dequantize_blockwise8_plain(qk, ak, dyn_t, 4096, torch.bfloat16)
    assert torch.equal(dk.view(torch.int16), dp.view(torch.int16)), "dequantize_blockwise8 differs (lm_head)"
    del dk, dp
    entry("dequantize_blockwise8",
          cuda_time(lambda: dequantize_blockwise8(qk, ak, dyn, 4096, torch.bfloat16), flush_l2=True)["median"],
          cuda_time(lambda: dequantize_blockwise8_plain(qk, ak, dyn_t, 4096, torch.bfloat16), n=3)["median"],
          None, n_l + n_l // 4096 * 4 + n_l * 2, n_l, PEAK_F32_FLOPS, 0.0,
          shape=[32000, 4096], blocksize=4096, dtype="bfloat16",
          note="the lm_head-sized round trip of phase 4c", nested_absmax=d12)
    del xl, qk, ak
    torch.cuda.empty_cache()

    # -- 3g. ragged shapes of the new kernels -------------------------------
    cases = []
    # (1, 64, 768, 32) and Llama's down (K/bs = 224) straddle 256-block boundaries within a column
    for Mx, N, K, gbs in ((1, 64, 768, 32), (3, 18, 96, 32), (13, 130, 4160, 64), (31, 256, 2176, 128),
                          (5, 64, 8192, 4096), (2, 4096, 14336, 64)):
        qw = QuantizedTensor.quantize(torch.randn(N, K, generator=gen, device=dev), blocksize=gbs,
                                      compress_statistics=True)
        st = qw.state
        args = (qw.data, st.absmax, st.state2.absmax, st.offset)
        A = torch.randn(Mx, K, generator=gen, device=dev).to(torch.bfloat16)
        out = gemm_4bit_paired_dq(A, *args, code, gbs, (N, K), out_dtype=torch.float32)
        ref = gemm_4bit_paired_dq_plain(A, *args, units, gbs)
        assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-3, f"gemm_dq {(Mx, N, K, gbs)}"
        assert torch.equal(out, gemm_4bit_paired(A, qw.data, st.dequant_absmax_t(), code, gbs, (N, K),
                                                 out_dtype=torch.float32)), f"gemm_dq vs resolved {(Mx, N, K, gbs)}"
        Wk = dequantize_paired_fast_dq(*args, code, gbs)
        assert torch.equal(Wk, dequantize_paired_fast_dq_plain(*args, units, gbs, torch.bfloat16)), (N, K, gbs)
        cases.append(f"gemm_dq+dequant_dq M{Mx} N{N} K{K} bs{gbs}")
    for bbs in (32, 64, 128, 256, 512, 1024, 2048, 4096):
        n = 5 * bbs + bbs // 2 + 3  # a partial last block, padded by the functional layer
        xb = torch.randn(n, generator=gen, device=dev)
        xb[bbs : 2 * bbs] = 0.0  # a zero block
        padded = torch.nn.functional.pad(xb, (0, 6 * bbs - n))
        u = torch.rand(padded.numel(), generator=gen, device=dev)
        for uu in (None, u):
            qk, ak = quantize_blockwise8(padded, dyn, bbs, uu)
            qp, ap_ = quantize_blockwise8_plain(padded, dyn_t, bbs, uu)
            assert torch.equal(qk, qp) and torch.equal(ak, ap_), f"quantize_blockwise8 bs{bbs} u={uu is not None}"
            assert (qk[bbs : 2 * bbs] == 0).all(), "a zero block ranks 0"
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            assert torch.equal(dequantize_blockwise8(qk, ak, dyn, bbs, dt),
                               dequantize_blockwise8_plain(qk, ak, dyn_t, bbs, dt)), f"dequantize_blockwise8 {bbs} {dt}"
        qf, sf = FB.quantize_blockwise(xb, blocksize=bbs, nested=True)
        assert qf.shape == xb.shape and torch.isfinite(FB.dequantize_blockwise(qf, sf)).all()
        cases.append(f"blockwise8 bs{bbs} n{n} zero-block stochastic f32/bf16/f16")
    emit("ragged_shapes_nested", passed=cases)

    # -- 3h. kernels 7 and 8: the backward g @ dequant(B) ------------------
    def nt_rel(out, ref):
        return ((out.float() - ref).abs().max() / ref.abs().max()).item()

    def nt_tol(dt):
        return 1e-5 if dt == torch.float32 else 1e-2

    cases = []
    for Mx, N, K, gbs in ((1, 2, 32, 32), (3, 18, 96, 32), (7, 64, 768, 32), (13, 130, 4160, 64),
                          (16, 256, 2176, 128), (31, 512, 4096, 256), (2, 4096, 14336, 64)):
        for compress in (False, True):
            qw = QuantizedTensor.quantize(torch.randn(N, K, generator=gen, device=dev), blocksize=gbs,
                                          compress_statistics=compress)
            st = qw.state
            for dt in (torch.bfloat16, torch.float32, torch.float16):
                Gx = torch.randn(Mx, N, generator=gen, device=dev).to(dt)
                if compress:
                    args = (qw.data, st.absmax, st.state2.absmax, st.offset)
                    out = gemm_4bit_paired_nt_dq(Gx, *args, code, gbs, (N, K))
                    ref = gemm_4bit_paired_nt_dq_plain(Gx, *args, units, gbs)
                    # kernel 8 on the nested state gives kernel 7's bits on the resolved absmax
                    assert torch.equal(out, gemm_4bit_paired_nt(Gx, qw.data, st.dequant_absmax_t(), code, gbs,
                                                                (N, K))), f"nt_dq vs resolved {(Mx, N, K, gbs)}"
                else:
                    out = gemm_4bit_paired_nt(Gx, qw.data, st.absmax, code, gbs, (N, K))
                    ref = gemm_4bit_paired_nt_plain(Gx, qw.data, st.absmax, units, gbs)
                assert out.dtype == dt and out.shape == (Mx, K)
                rel = nt_rel(out, ref)
                assert rel <= nt_tol(dt), f"nt {(Mx, N, K, gbs, compress, dt)}: rel {rel}"
                cases.append(f"nt{'_dq' if compress else ''} M{Mx} N{N} K{K} bs{gbs} {str(dt)[6:]} rel {rel:.2e}")
    emit("ragged_shapes_backward", passed=cases)

    def nt_layer(compress):
        """Kernel 7 (or 8) on one layer's four linears transposed, M = 16."""
        M = 16
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0, "ops": 0, "err": 0.0, "f16": 0.0}
        per_shape = []
        for name, (N, K) in LINEARS.items():
            Wf = torch.randn(N, K, generator=gen, device=dev) * K**-0.5
            qw = QuantizedTensor.quantize(Wf, blocksize=bs, compress_statistics=compress)
            del Wf
            st = qw.state
            Gx = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
            if compress:
                args = (qw.data, st.absmax, st.state2.absmax, st.offset)
                run = lambda: gemm_4bit_paired_nt_dq(Gx, *args, code, bs, (N, K))  # noqa: E731
                plain = lambda: gemm_4bit_paired_nt_dq_plain(Gx, *args, units, bs)  # noqa: E731
                Wb = dequantize_paired_fast_dq_plain(*args, units, bs, torch.bfloat16)
                sbytes = (K // bs) * N + st.state2.absmax.numel() * 4 + 4
            else:
                run = lambda: gemm_4bit_paired_nt(Gx, qw.data, st.absmax, code, bs, (N, K))  # noqa: E731
                plain = lambda: gemm_4bit_paired_nt_plain(Gx, qw.data, st.absmax, units, bs)  # noqa: E731
                Wb = dequantize_paired_fast_plain(qw.data, st.absmax, units, bs, torch.bfloat16)
                sbytes = (K // bs) * N * 4
            out, ref = run(), plain()
            rel = nt_rel(out, ref)
            assert rel <= 1e-2, f"nt {name}: rel {rel}"
            ms = cuda_time(run, flush_l2=True)["median"]
            pms = cuda_time(plain, n=3)["median"]
            lms = cuda_time(lambda: torch.matmul(Gx, Wb), flush_l2=True)["median"]
            Gx = Gx.to(torch.float16)  # the same linear with f16 g
            assert nt_rel(run(), plain()) <= 1e-2, f"nt {name} f16"
            tot["f16"] += cuda_time(run, flush_l2=True)["median"]
            nbytes = M * N * 2 + N * K // 2 + sbytes + M * K * 2
            per_shape.append({"linear": name + "^T", "N": N, "K": K, "M": M, "ms": ms, "plain_ms": pms,
                              "library_ms": lms, "bytes": nbytes,
                              "bound_ms": bound_ms(nbytes, 2 * M * N * K, PEAK_BF16_FLOPS)[0], "rel_err": rel})
            for key, v in (("ms", ms), ("plain", pms), ("lib", lms), ("bytes", nbytes), ("ops", 2 * M * N * K)):
                tot[key] += v
            tot["err"] = max(tot["err"], (out.float() - ref).abs().max().item())
            del qw, Wb, out, ref
        return tot, per_shape

    for name, compress in (("gemm_4bit_paired_nt", False), ("gemm_4bit_paired_nt_dq", True)):
        tot, per_shape = nt_layer(compress)
        entry(name, tot["ms"], tot["plain"], tot["lib"], tot["bytes"], tot["ops"], PEAK_BF16_FLOPS, tot["err"],
              per_shape=per_shape, f16_g_ms=tot["f16"],
              note="sum over one layer's 4 linears transposed, M=16, bf16 g; library: "
                   "torch.matmul(g, W) on the dequantized bf16 weight; f16_g_ms: the same with f16 g")
    torch.cuda.empty_cache()

    # -- 3i. kernel 14: the fused 8-bit optimizer update --------------------
    q1_map, q2_map = create_dynamic_map(signed=True), create_dynamic_map(signed=False)
    q1_t, q2_t = tuple(float(v) for v in q1_map), tuple(float(v) for v in q2_map)
    codes1, codes2 = StateCodes(q1_map), StateCodes(q1_map, q2_map)
    hyper = {"adam": (0.9, 0.999, 1e-8, 1e-2, 1e-3), "lamb": (0.9, 0.999, 1e-8, 0.0, 1e-3),
             "momentum": (0.9, 0.0, 0.0, 1e-2, 1e-2), "lars": (0.9, 0.0, 0.0, 0.0, 1e-2),
             "lion": (0.9, 0.99, 0.0, 1e-2, 1e-4), "rmsprop": (0.99, 0.0, 1e-8, 0.0, 1e-2),
             "adagrad": (0.0, 0.0, 1e-10, 1e-2, 1e-2)}

    def opt_inputs(name, n, zero_block=False, dtype=torch.float32):
        nb = -(-n // 256)
        g = torch.randn(n, generator=gen, device=dev) * 0.01
        g[7], g[600] = float("nan"), float("inf")
        p = torch.randn(n, generator=gen, device=dev)
        g, p = g.to(dtype), p.to(dtype)
        lo = 127 if name in ("rmsprop", "adagrad") else 0  # a non-negative state1
        s1 = torch.randint(lo, 256, (n,), generator=gen, device=dev, dtype=torch.uint8)
        am1 = torch.rand(nb, generator=gen, device=dev) * 0.01
        two = name in ("adam", "lamb")
        s2 = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8) if two else None
        am2 = torch.rand(nb, generator=gen, device=dev) * 1e-4 if two else None
        if zero_block:  # a block whose new states are all zero
            g[256:512] = 0.0
            s1[256:512] = 127 if lo else 0
            am1[1] = 0.0
            if two:
                s2[256:512] = 0
                am2[1] = 0.0
        return g, p, s1, s2, am1, am2

    def opt_check(name, step, n, zero_block, dtype=torch.float32):
        b1, b2, eps, wd, lr = hyper[name]
        sc = UpdateScalars.make(name, beta1=b1, beta2=b2, eps=eps, weight_decay=wd, step=step, lr=lr)
        g, p, s1, s2, am1, am2 = opt_inputs(name, n, zero_block, dtype)
        ref = optimizer_update_8bit_plain(sc, g, p, s1, s2, am1, am2, q1_t, q2_t if s2 is not None else None, True)
        kout = [None if t is None else t.clone() for t in (p, s1, s2, am1, am2)]
        optimizer_update_8bit_(sc, g, *kout, codes2 if s2 is not None else codes1)
        torch.cuda.synchronize()
        assert kout[0].dtype == dtype
        if dtype == torch.float32:
            ulp = (kout[0].view(torch.int32).long() - ref[0].view(torch.int32).long()).abs().max().item()
        else:  # a parameter stored in 16 bits is held bit for bit
            ulp = int(not torch.equal(kout[0].view(torch.int16), ref[0].view(torch.int16)))
            assert ulp == 0, f"optimizer {name} step {step} n {n} {dtype}: params differ"
        assert ulp <= 1, f"optimizer {name} step {step} n {n}: params {ulp} ulp apart"
        for k, r, what in zip(kout[1:], ref[1:], ("state1", "state2", "absmax1", "absmax2")):
            assert (k is None) == (r is None) and (k is None or torch.equal(k, r)), f"optimizer {name} {what}"
        assert kout[0][7].item() == p[7].item() and kout[0][600].item() == p[600].item(), "non-finite g moved p"
        return {"rule": name, "step": step, "n": n, "zero_block": zero_block, "param_ulp": ulp,
                "dtype": str(dtype)[6:]}

    checks = [opt_check(name, step, 2048 + 100, step == 1) for name in hyper for step in (1, 5)]
    checks += [opt_check(name, 5, 14336 * 64, False) for name in ("adam", "lion")]
    checks += [opt_check(name, step, 2048 + 100, step == 1, dt) for name in hyper for step in (1, 5)
               for dt in (torch.bfloat16, torch.float16)]
    checks += [opt_check("adam", 5, 14336 * 64, False, torch.bfloat16)]

    def opt_time(n, dtype=torch.float32):
        """Kernel 14 (adamw, step 5) on an n-element leaf, its plain
        version, and torch.optim.AdamW(fused=True) on f32 states of the same
        size, a different function (no PyTorch call keeps 8-bit states)."""
        sc = UpdateScalars.make("adam", beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-2, step=5, lr=1e-3)
        g, p, s1, s2, am1, am2 = opt_inputs("adam", n, dtype=dtype)
        ms = cuda_time(lambda: optimizer_update_8bit_(sc, g, p, s1, s2, am1, am2, codes2), flush_l2=True)["median"]
        pms = cuda_time(lambda: optimizer_update_8bit_plain(sc, g, p, s1, s2, am1, am2, q1_t, q2_t, True),
                        n=3, warmup=1)["median"]
        tp = torch.nn.Parameter(p.clone())
        tp.grad = torch.nan_to_num(g, nan=0.0, posinf=0.0)
        fused = torch.optim.AdamW([tp], lr=1e-3, weight_decay=1e-2, fused=True)
        fused.step()
        fms = cuda_time(fused.step, flush_l2=True)["median"]
        # g read, p read and written, two uint8 states and two absmax read and written
        nbytes = n * 3 * p.element_size() + 2 * (2 * n + 8 * -(-n // 256))
        return {"n": n, "ms": ms, "plain_ms": pms, "adamw_fused_f32_ms": fms, "bytes": nbytes,
                "bound_ms": bound_ms(nbytes, 25 * n, PEAK_F32_FLOPS)[0], "dtype": str(dtype)[6:]}

    lora_leaf = opt_time(14336 * 64)  # the gate adapter's b [14336, 64]
    big_leaf = opt_time(64 << 20)
    lora_leaf_bf16 = opt_time(14336 * 64, torch.bfloat16)
    torch.cuda.empty_cache()
    entry("optimizer_update_8bit", lora_leaf["ms"], lora_leaf["plain_ms"], None, lora_leaf["bytes"],
          25 * lora_leaf["n"], PEAK_F32_FLOPS, 0.0, shape=[14336, 64], rule="adamw, step 5", cases=checks,
          leaf_64M=big_leaf, bf16_params=lora_leaf_bf16, adamw_fused_f32_ms=lora_leaf["adamw_fused_f32_ms"],
          note="library_ms is null: no PyTorch call keeps 8-bit states; adamw_fused_f32_ms is "
               "torch.optim.AdamW(fused=True) on f32 states of the same size, a different function")

    # -- 3j. the backward threshold: kernel 7 against kernel 3 + matmul ------
    sweep = []
    for name in ("gate_up", "down"):
        N, K = LINEARS[name]
        qw = QuantizedTensor.quantize(torch.randn(N, K, generator=gen, device=dev) * K**-0.5, blocksize=bs)
        P, am_t = qw.data, qw.state.absmax
        for Mx in (1, 8, 16, 32, 64, 128):
            Gx = torch.randn(Mx, N, generator=gen, device=dev).to(torch.bfloat16)
            k7 = cuda_time(lambda: gemm_4bit_paired_nt(Gx, P, am_t, code, bs, (N, K)), n=10, flush_l2=True)
            k3 = cuda_time(lambda: torch.matmul(Gx, dequantize_paired_fast(P, am_t, code, bs)), n=10,
                           flush_l2=True)
            sweep.append({"linear": name + "^T", "M": Mx, "nt_kernel_ms": k7["median"],
                          "dequant_matmul_ms": k3["median"]})
        del qw
    emit("backward_threshold_sweep", BACKWARD_LARGE_M_THRESHOLD=G.BACKWARD_LARGE_M_THRESHOLD, points=sweep)
    torch.cuda.empty_cache()

    # -- 3k. kernel 4 with int8 KV, and kernel 16 (paged, bf16 and int8) ----
    B, S = 16, 1024
    kc = torch.randn(B, KVH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(B, KVH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    (k8, ks8), (v8, vs8) = L._quantize_kv(kc), L._quantize_kv(vc)
    # the int8 cache dequantized to bf16: SDPA's input for the int8 yardstick
    kd, vd = ((c.float() * s[..., None]).to(torch.bfloat16) for c, s in ((k8, ks8), (v8, vs8)))
    # ragged: an empty slot (position 0), both sides of a 128 boundary, the last position
    lens = torch.randint(1, S, (B,), generator=gen, device=dev, dtype=torch.int32)
    lens[:4] = torch.tensor([0, 127, 128, S - 1], dtype=torch.int32, device=dev)
    pre_len = torch.full((B,), 255, dtype=torch.int32, device=dev)
    q1 = torch.randn(B, KVH, Gq, hd, generator=gen, device=dev).to(torch.bfloat16)
    q_pre = torch.randn(B, KVH, Gq * 128, hd, generator=gen, device=dev).to(torch.bfloat16)
    cases_k = [("decode", 1, q1, lens, None), ("window 200", 1, q1, lens, 200), ("prefill T 128", 128, q_pre, pre_len, None)]

    def sdpa_mask(lengths, T, window=None):
        """The kernels' mask as SDPA's ``attn_mask`` [B, 1, T, S]."""
        q_pos = lengths[:, None].long() - (T - 1) + torch.arange(T, device=dev)[None, :]
        kv = torch.arange(S, device=dev)[None, None, :]
        mask = kv <= q_pos[:, :, None]
        if window:
            mask &= kv > q_pos[:, :, None] - window
        return mask[:, None]

    def sdpa(q, k, v, mask):
        """Heads h = kvh*G + g, as the fold's rows r = g*T + t."""
        return F.scaled_dot_product_attention(q.reshape(B, KVH * Gq, -1, hd), k, v, attn_mask=mask, enable_gqa=True)

    masks = {what: sdpa_mask(lengths, T, win) for what, T, _, lengths, win in cases_k}

    def close(out, ref, what, tol=0.02):
        err = (out.float() - ref.float()).abs().max().item()
        assert torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol), f"{what}: max abs err {err}"
        return err

    def att_bytes(q, live, elem, scales, table_entries=0):
        """q read and out written, each live K and V row once (and its two
        scales), the lengths, and the table entries that reach live blocks."""
        return 2 * q.numel() * 2 + live * KVH * hd * 2 * elem + (live * KVH * 2 * 4 if scales else 0) + B * 4 \
            + table_entries * 4

    live_dec = (lens.long() + 1).sum().item()  # positions read per kv head
    live_pre = (pre_len.long() + 1).sum().item()
    err8 = 0.0
    for what, T, q, lengths, win in cases_k:
        out = flash_attention_cached(q, k8, v8, lengths, T=T, k_scale=ks8, v_scale=vs8, window=win)
        ref = flash_attention_cached_plain(q, k8, v8, lengths, T, win, torch.bfloat16, ks8, vs8)
        err8 = max(err8, close(out, ref, f"flash int8 {what}"))
        close(sdpa(q, kd, vd, masks[what]), out.reshape(B, KVH * Gq, T, hd), f"flash int8 vs SDPA {what}", 0.05)
    k4 = {
        "int8": cuda_time(lambda: flash_attention_cached(q1, k8, v8, lens, T=1, k_scale=ks8, v_scale=vs8),
                          flush_l2=True)["median"],
        "bf16": cuda_time(lambda: flash_attention_cached(q1, kc, vc, lens, T=1), flush_l2=True)["median"],
        "int8_device": cuda_time(lambda: flash_attention_cached(q1, k8, v8, lens, T=1, k_scale=ks8, v_scale=vs8),
                                 flush_l2=True, hold=True)["median"],
        "bf16_device": cuda_time(lambda: flash_attention_cached(q1, kc, vc, lens, T=1), flush_l2=True,
                                 hold=True)["median"],
    }
    pre8 = {
        "ms": cuda_time(lambda: flash_attention_cached(q_pre, k8, v8, pre_len, T=128, k_scale=ks8, v_scale=vs8),
                        flush_l2=True)["median"],
        "plain_ms": cuda_time(lambda: flash_attention_cached_plain(q_pre, k8, v8, pre_len, 128, None, torch.bfloat16,
                                                                   ks8, vs8), n=5)["median"],
        "library_ms": cuda_time(lambda: sdpa(q_pre, kd, vd, masks["prefill T 128"]), flush_l2=True)["median"],
        "device_ms": cuda_time(lambda: flash_attention_cached(q_pre, k8, v8, pre_len, T=128, k_scale=ks8,
                                                              v_scale=vs8), flush_l2=True, hold=True)["median"],
        "bytes": att_bytes(q_pre, live_pre, 1, True), "ops": 4 * hd * Gq * 128 * live_pre * KVH,
    }
    pre8["bound_ms"], pre8["bound_by"] = bound_ms(pre8["bytes"], pre8["ops"], PEAK_BF16_FLOPS)
    dec_ops = 4 * hd * Gq * live_dec * KVH
    entry("flash_attention_cached_int8", k4["int8"],
          cuda_time(lambda: flash_attention_cached_plain(q1, k8, v8, lens, 1, None, torch.bfloat16, ks8, vs8),
                    n=5)["median"],
          cuda_time(lambda: sdpa(q1, kd, vd, masks["decode"]), flush_l2=True)["median"],
          att_bytes(q1, live_dec, 1, True), dec_ops, PEAK_BF16_FLOPS, err8,
          decode={"B": B, "KVH": KVH, "G": Gq, "S": S, "T": 1, "lengths": lens.tolist()},
          prefill_chunk={"T": 128, "length": 255, **pre8}, bf16_same_lengths_ms=k4["bf16"],
          device_ms=k4["int8_device"], bf16_same_lengths_device_ms=k4["bf16_device"],
          library_device_ms=cuda_time(lambda: sdpa(q1, kd, vd, masks["decode"]), flush_l2=True, hold=True)["median"],
          note="library_ms: SDPA on the int8 cache dequantized to bf16, a different function (twice the KV "
               "bytes); bf16_same_lengths_ms: kernel 4 on the bf16 cache at the same lengths, same run")

    def scatter(BS):
        """A shuffled pool (one spare block) holding the dense caches, and the tables."""
        MAXB = S // BS
        NB = B * MAXB + 1
        perm = torch.randperm(NB, generator=torch.Generator().manual_seed(BS))[: B * MAXB]
        tables = perm.reshape(B, MAXB).to(torch.int32).to(dev).contiguous()

        def pool(a):  # [B, KVH, S(, hd)] -> [NB, KVH, BS(, hd)]
            rest = tuple(a.shape[3:])
            p = torch.zeros((NB, KVH, BS) + rest, dtype=a.dtype, device=dev)
            p[tables.reshape(-1).long()] = a.reshape(B, KVH, MAXB, BS, *rest).transpose(1, 2).reshape(
                B * MAXB, KVH, BS, *rest)
            return p

        return tables, pool

    for int8 in (False, True):
        name = "flash_attention_paged_int8" if int8 else "flash_attention_paged"
        per_bs, err16, head = [], 0.0, None
        for BS in (16, 64, 128, 256):
            tables, pool = scatter(BS)
            pk, pv = (pool(k8), pool(v8)) if int8 else (pool(kc), pool(vc))
            pks, pvs = (pool(ks8), pool(vs8)) if int8 else (None, None)
            dk, dv, dks, dvs = (k8, v8, ks8, vs8) if int8 else (kc, vc, None, None)
            for what, T, q, lengths, win in cases_k:
                out = flash_attention_paged(q, pk, pv, tables, lengths, T=T, k_scale=pks, v_scale=pvs, window=win)
                ref = flash_attention_paged_plain(q, pk, pv, tables, lengths, T, win, torch.bfloat16, pks, pvs)
                err16 = max(err16, close(out, ref, f"{name} BS {BS} {what}"))
                again = flash_attention_paged(q, pk, pv, tables, lengths, T=T, k_scale=pks, v_scale=pvs, window=win)
                assert torch.equal(out.view(torch.int16), again.view(torch.int16)), \
                    f"{name} BS {BS} {what}: differs from run to run"
                dense = flash_attention_cached(q, dk, dv, lengths, T=T, k_scale=dks, v_scale=dvs, window=win)
                assert torch.equal(out.view(torch.int16), dense.view(torch.int16)), \
                    f"{name} BS {BS} {what}: differs from kernel 4 on the same data"
            entries = (lens.long() // BS + 1).sum().item()
            row = {"BS": BS,
                   "ms": cuda_time(lambda: flash_attention_paged(q1, pk, pv, tables, lens, T=1, k_scale=pks,
                                                                 v_scale=pvs), flush_l2=True)["median"],
                   "plain_ms": cuda_time(lambda: flash_attention_paged_plain(q1, pk, pv, tables, lens, 1, None,
                                                                             torch.bfloat16, pks, pvs), n=5)["median"],
                   "device_ms": cuda_time(lambda: flash_attention_paged(q1, pk, pv, tables, lens, T=1, k_scale=pks,
                                                                        v_scale=pvs), flush_l2=True, hold=True)["median"],
                   "bytes": att_bytes(q1, live_dec, 1 if int8 else 2, int8, entries)}
            row["bound_ms"] = bound_ms(row["bytes"], dec_ops, PEAK_BF16_FLOPS)[0]
            per_bs.append(row)
            if BS == 128:
                head = row
            del pk, pv, pks, pvs
        entry(name, head["ms"], head["plain_ms"],
              None if int8 else cuda_time(lambda: sdpa(q1, kc, vc, masks["decode"]), flush_l2=True)["median"],
              head["bytes"], dec_ops, PEAK_BF16_FLOPS, err16, block_size=128, per_block_size=per_bs,
              decode={"B": B, "KVH": KVH, "G": Gq, "S": S, "T": 1, "lengths": lens.tolist()},
              kernel4_same_data_ms=k4["int8" if int8 else "bf16"], equals_kernel4_bitwise=True,
              kernel4_same_data_device_ms=k4["int8_device" if int8 else "bf16_device"],
              checked=[c[0] for c in cases_k],
              note=("library_ms null: no PyTorch call reads an int8 paged pool" if int8 else
                    "library_ms: SDPA on the contiguous bf16 cache the pool was scattered from (gather excluded)"))

    # kernels 4 and 16 at head_dim 64 and 256, bf16 and int8: each case
    # against the plain version and twice bit for bit, then kernel 16 at
    # every block size against kernel 4's bits on the same data
    hd_checks = []
    for hd_x in (64, 256):
        kx, vx = (torch.randn(B, KVH, S, hd_x, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        (k8x, ks8x), (v8x, vs8x) = L._quantize_kv(kx), L._quantize_kv(vx)
        q1x = torch.randn(B, KVH, Gq, hd_x, generator=gen, device=dev).to(torch.bfloat16)
        q_prex = torch.randn(B, KVH, Gq * 128, hd_x, generator=gen, device=dev).to(torch.bfloat16)
        cases_x = [("decode", 1, q1x, lens, None), ("window 200", 1, q1x, lens, 200),
                   ("prefill T 128", 128, q_prex, pre_len, None)]
        for int8 in (False, True):
            dk, dv, dks, dvs = (k8x, v8x, ks8x, vs8x) if int8 else (kx, vx, None, None)
            dense, err_x = [], 0.0
            for what, T, q, lengths, win in cases_x:
                out = flash_attention_cached(q, dk, dv, lengths, T=T, k_scale=dks, v_scale=dvs, window=win)
                ref = flash_attention_cached_plain(q, dk, dv, lengths, T, win, torch.bfloat16, dks, dvs)
                err_x = max(err_x, close(out, ref, f"flash hd {hd_x} int8 {int8} {what}"))
                again = flash_attention_cached(q, dk, dv, lengths, T=T, k_scale=dks, v_scale=dvs, window=win)
                assert torch.equal(out.view(torch.int16), again.view(torch.int16)), \
                    f"flash hd {hd_x} int8 {int8} {what}: differs from run to run"
                dense.append(out)
            for BS in (16, 64, 128, 256):
                tables, pool = scatter(BS)
                pk, pv = pool(dk), pool(dv)
                pks, pvs = (pool(dks), pool(dvs)) if int8 else (None, None)
                for (what, T, q, lengths, win), out in zip(cases_x, dense):
                    po = flash_attention_paged(q, pk, pv, tables, lengths, T=T, k_scale=pks, v_scale=pvs, window=win)
                    assert torch.equal(po.view(torch.int16), out.view(torch.int16)), \
                        f"paged hd {hd_x} int8 {int8} BS {BS} {what}: differs from kernel 4 on the same data"
                del pk, pv, pks, pvs
            hd_checks.append({"head_dim": hd_x, "int8": int8, "max_abs_err": err_x, "cases": [c[0] for c in cases_x],
                              "paged_block_sizes": [16, 64, 128, 256], "paged_equals_dense_bitwise": True,
                              "run_to_run_bit_identical": True})
        del kx, vx, k8x, v8x, ks8x, vs8x, q1x, q_prex
    emit("flash_head_dims", B=B, KVH=KVH, G=Gq, S=S, checks=hd_checks)
    torch.cuda.empty_cache()

    # -- 3l. kernels 9, 10 and 11: the K-adjacent layout (bf16 quant_storage) --
    def kadj(qt):
        """(payload bytes, f32 absmax) of a flat/2d state, a nested one decoded."""
        return payload_bytes(qt.data).reshape(-1), qt.state.dequant_absmax().contiguous()

    def rel_err(out, ref):
        return ((out.float() - ref).abs().max() / ref.abs().max()).item()

    cases, k9_err, k11_err = [], 0.0, 0.0
    for Mx, N, K, gbs in ((1, 3, 32, 32), (3, 37, 96, 32), (7, 129, 4160, 64), (13, 255, 2176, 128),
                          (31, 513, 4096, 256), (5, 64, 8192, 4096), (2, 77, 14336, 512), (9, 31, 2048, 1024),
                          (4, 17, 4096, 2048), (16, 4096, 14336, 64)):
        for compress in (False, True):
            qw = QuantizedTensor.quantize(torch.randn(N, K, generator=gen, device=dev), blocksize=gbs,
                                          compress_statistics=compress, quant_storage=torch.bfloat16)
            assert qw.state.layout == "2d" and qw.data.dtype == torch.uint16
            Bq, am = kadj(qw)
            ct = tuple(float(v) for v in get_4bit_code("nf4", gbs))
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                Wk = dequantize_4bit_2d(Bq, am, code, gbs, (N, K), dt)
                assert torch.equal(Wk.view(torch.uint8), dequantize_4bit_2d_plain(Bq, am, ct, gbs, (N, K), dt).view(
                    torch.uint8)), f"dequantize_4bit_2d {(N, K, gbs, dt)}"
                A = torch.randn(Mx, K, generator=gen, device=dev).to(dt)
                out = gemm_4bit_fused(A, Bq, am, code, gbs, (N, K), out_dtype=torch.float32)
                ref = gemm_4bit_fused_plain(A, Bq, am, ct, gbs, N)
                rel = rel_err(out, ref)
                assert rel <= 1e-5, f"gemm_4bit_fused {(Mx, N, K, gbs, compress, dt)}: rel {rel}"
                assert torch.equal(gemm_4bit_fused(A, Bq, am, code, gbs, (N, K)), out.to(dt)), "kernel 9 in A's type"
                Gx = torch.randn(Mx, N, generator=gen, device=dev).to(dt)
                o11 = gemm_4bit_nt_fused(Gx, Bq, am, code, gbs, (N, K))
                rel11 = rel_err(o11, gemm_4bit_nt_fused_plain(Gx, Bq, am, ct, gbs, K))
                assert o11.dtype == dt and rel11 <= nt_tol(dt), f"gemm_4bit_nt_fused {(Mx, N, K, gbs, dt)}: {rel11}"
                k9_err, k11_err = max(k9_err, rel), max(k11_err, rel11 if dt == torch.float32 else 0.0)
            cases.append(f"k9/k10/k11 M{Mx} N{N} K{K} bs{gbs} nested={compress} f32/bf16/f16")
    for shape, fbs in (((7, 77), 64), ((1, 4099), 32)):  # flat layouts, blocks across rows, an odd count
        qw = QuantizedTensor.quantize(torch.randn(*shape, generator=gen, device=dev), blocksize=fbs)
        assert qw.state.layout == "flat"
        ct = tuple(float(v) for v in get_4bit_code("nf4", fbs))
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(qw.dequantize().to(dt), dequantize_4bit_2d_plain(qw.data, qw.state.absmax, ct, fbs,
                                                                                  shape, dt)), f"flat {shape}"
        cases.append(f"k10 flat {shape} bs{fbs}")
    emit("ragged_shapes_kadjacent", passed=cases, k9_max_rel=k9_err, k11_max_rel_f32=k11_err)

    kq = {}
    for name, (N, K) in LINEARS.items():
        Wf = torch.randn(N, K, generator=gen, device=dev) * K**-0.5
        kq[name] = QuantizedTensor.quantize(Wf, blocksize=bs, compress_statistics=True, quant_storage=torch.bfloat16)
        del Wf
    code_t = tuple(float(v) for v in code)

    def kadj_layer(M, backward):
        """Kernel 9 (or 11, transposed) on one layer's four linears, the
        nested absmax decoded before each call as the path does (timed apart)."""
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "decode": 0.0, "bytes": 0, "ops": 0, "err": 0.0}
        per_shape = []
        for name, (N, K) in LINEARS.items():
            qt = kq[name]
            Bq, am = kadj(qt)
            Wb = dequantize_4bit_2d_plain(Bq, am, code_t, bs, (N, K), torch.bfloat16)
            if backward:
                X = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
                run = lambda: gemm_4bit_nt_fused(X, Bq, am, code, bs, (N, K))  # noqa: E731
                plain = lambda: gemm_4bit_nt_fused_plain(X, Bq, am, code_t, bs, K)  # noqa: E731
                lib = lambda: torch.matmul(X, Wb)  # noqa: E731
            else:
                X = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                run = lambda: gemm_4bit_fused(X, Bq, am, code, bs, (N, K), out_dtype=torch.float32)  # noqa: E731
                plain = lambda: gemm_4bit_fused_plain(X, Bq, am, code_t, bs, N)  # noqa: E731
                lib = lambda: torch.matmul(X, Wb.t())  # noqa: E731
            out, ref = run(), plain()
            rel = rel_err(out, ref)
            assert rel <= (1e-2 if backward else 1e-5), f"{'k11' if backward else 'k9'} {name}: rel {rel}"
            if not backward:
                run = lambda: gemm_4bit_fused(X, Bq, am, code, bs, (N, K))  # noqa: E731
            ms = cuda_time(run, flush_l2=True)["median"]
            pms = cuda_time(plain, n=3)["median"]
            lms = cuda_time(lib, flush_l2=True)["median"]
            dms = cuda_time(qt.state.dequant_absmax, n=5)["median"]
            nbytes = M * (N if backward else K) * 2 + N * K // 2 + (K // bs) * N * 4 + M * (K if backward else N) * 2
            per_shape.append({"linear": name + ("^T" if backward else ""), "N": N, "K": K, "M": M, "ms": ms,
                              "plain_ms": pms, "library_ms": lms, "nested_decode_ms": dms, "bytes": nbytes,
                              "bound_ms": bound_ms(nbytes, 2 * M * N * K, PEAK_BF16_FLOPS)[0], "rel_err": rel})
            for key, v in (("ms", ms), ("plain", pms), ("lib", lms), ("decode", dms), ("bytes", nbytes),
                           ("ops", 2 * M * N * K)):
                tot[key] += v
            tot["err"] = max(tot["err"], (out.float() - ref).abs().max().item())
            del Wb, out, ref
        return tot, per_shape

    for name, M, backward in (("gemm_4bit_fused", 8, False), ("gemm_4bit_nt_fused", 16, True)):
        tot, per_shape = kadj_layer(M, backward)
        entry(name, tot["ms"], tot["plain"], tot["lib"], tot["bytes"], tot["ops"], PEAK_BF16_FLOPS, tot["err"],
              per_shape=per_shape, nested_decode_ms=tot["decode"],
              note=f"sum over one layer's 4 linears{' transposed' if backward else ''} at M={M}, bf16 "
                   f"{'g' if backward else 'A'}, bf16 quant_storage, the nested absmax decoded to f32 beforehand "
                   "(nested_decode_ms: that decode, the path's per-call cost, timed apart); library: torch.matmul "
                   "on the dequantized bf16 weight")

    N, K = LINEARS["gate_up"]
    Bq, am = kadj(kq["gate_up"])
    assert torch.equal(dequantize_4bit_2d(Bq, am, code, bs, (N, K)),
                       dequantize_4bit_2d_plain(Bq, am, code_t, bs, (N, K), torch.bfloat16)), "dequantize_4bit_2d"
    entry("dequantize_4bit_2d",
          cuda_time(lambda: dequantize_4bit_2d(Bq, am, code, bs, (N, K)), flush_l2=True)["median"],
          cuda_time(lambda: dequantize_4bit_2d_plain(Bq, am, code_t, bs, (N, K), torch.bfloat16), n=3)["median"],
          None, N * K // 2 + (K // bs) * N * 4 + N * K * 2, N * K, PEAK_F32_FLOPS, 0.0, shape=[N, K],
          dtype="bfloat16", nested_decode_ms=cuda_time(kq["gate_up"].state.dequant_absmax, n=5)["median"],
          note="gate_up, the absmax decoded beforehand (nested_decode_ms, timed apart)")

    # the route sweep that sets the K-adjacent thresholds
    sweep = []
    for name in ("gate_up", "down"):
        N, K = LINEARS[name]
        Bq, am = kadj(kq[name])
        for Mx in (8, 16, 32, 64):
            A = torch.randn(Mx, K, generator=gen, device=dev).to(torch.bfloat16)
            Gx = torch.randn(Mx, N, generator=gen, device=dev).to(torch.bfloat16)
            sweep.append({
                "linear": name, "M": Mx,
                "k9_ms": cuda_time(lambda: gemm_4bit_fused(A, Bq, am, code, bs, (N, K)), n=10, flush_l2=True)["median"],
                "k10_matmul_ms": cuda_time(lambda: torch.matmul(A, dequantize_4bit_2d(Bq, am, code, bs, (N, K)).t()),
                                           n=10, flush_l2=True)["median"],
                "k11_ms": cuda_time(lambda: gemm_4bit_nt_fused(Gx, Bq, am, code, bs, (N, K)), n=10,
                                    flush_l2=True)["median"],
                "k10_matmul_T_ms": cuda_time(lambda: torch.matmul(Gx, dequantize_4bit_2d(Bq, am, code, bs, (N, K))),
                                             n=10, flush_l2=True)["median"]})
    emit("threshold_sweep_kadjacent", LARGE_M_THRESHOLD=G.LARGE_M_THRESHOLD,
         BACKWARD_LARGE_M_THRESHOLD=G.BACKWARD_LARGE_M_THRESHOLD, points=sweep)
    del kq
    torch.cuda.empty_cache()

    # -- 3m. kernel 15: the fused 8-bit AdEMAMix update ---------------------
    codes_a = StateCodes(q1_map, q2_map)

    def ada_inputs(n, zero_block=False, dtype=torch.float32):
        nb = -(-n // 256)
        g = torch.randn(n, generator=gen, device=dev) * 0.01
        g[7], g[min(600, n - 1)] = float("nan"), float("inf")
        p = torch.randn(n, generator=gen, device=dev)
        g, p = g.to(dtype), p.to(dtype)
        s1 = torch.randint(0, 256, (2, n), generator=gen, device=dev, dtype=torch.uint8)
        am1 = torch.rand(2, nb, generator=gen, device=dev) * 0.01
        s2 = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8)
        am2 = torch.rand(nb, generator=gen, device=dev) * 1e-4
        if zero_block:  # a block whose new states are all zero
            g[256:512] = 0.0
            s1[:, 256:512] = 127
            am1[:, 1] = 0.0
            s2[256:512] = 0
            am2[1] = 0.0
        return g, p, s1, s2, am1, am2

    def ada_scalars(step, wd, scheduled):
        alpha_t, beta3_t = O.base._ademamix_schedules(step, 5.0, 0.9999, 1000, 1000) if scheduled else (5.0, 0.9999)
        return UpdateScalars.make("ademamix", beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd, step=step, lr=1e-3,
                                  beta3=beta3_t, alpha=alpha_t)

    checks = []
    ada_cases = [(n, step, wd, scheduled, torch.float32) for n in (2048 + 100, 4096 + 3, 14336 * 64)
                 for step in (1, 5) for wd, scheduled in ((0.0, False), (1e-2, True))]
    ada_cases += [(n, step, 1e-2, True, dt) for n in (2048 + 100, 4096 + 3) for step in (1, 5)
                  for dt in (torch.bfloat16, torch.float16)]
    for n, step, wd, scheduled, dt in ada_cases:
        sc = ada_scalars(step, wd, scheduled)
        g, p, s1, s2, am1, am2 = ada_inputs(n, zero_block=step == 1, dtype=dt)
        ref = optimizer_update_8bit_plain(sc, g, p, s1, s2, am1, am2, q1_t, q2_t, True)
        kout = [t.clone() for t in (p, s1, s2, am1, am2)]
        optimizer_update_8bit_(sc, g, *kout, codes_a)
        torch.cuda.synchronize()
        for k, r, what in zip(kout, ref, ("param", "state1", "state2", "absmax1", "absmax2")):
            assert torch.equal(k.reshape(r.shape).view(torch.uint8), r.view(torch.uint8)), \
                f"ademamix n {n} step {step} wd {wd}: {what} differs"
        assert kout[0][7].item() == p[7].item() and (kout[1][:, 7] == 127).all(), "non-finite g"
        checks.append({"n": n, "step": step, "weight_decay": wd, "scheduled": scheduled,
                       "zero_block": step == 1, "dtype": str(dt)[6:], "bit_identical": True})

    def ada_time(n, dtype=torch.float32):
        """Kernel 15 (step 5, scheduled, decay) on an n-element leaf and its plain version."""
        sc = ada_scalars(5, 1e-2, True)
        g, p, s1, s2, am1, am2 = ada_inputs(n, dtype=dtype)
        ms = cuda_time(lambda: optimizer_update_8bit_(sc, g, p, s1, s2, am1, am2, codes_a), flush_l2=True)["median"]
        pms = cuda_time(lambda: optimizer_update_8bit_plain(sc, g, p, s1, s2, am1, am2, q1_t, q2_t, True),
                        n=3, warmup=1)["median"]
        # g read, p read and written, three uint8 states and three absmax read and written
        nbytes = n * 3 * p.element_size() + 3 * (2 * n + 8 * -(-n // 256))
        return {"n": n, "ms": ms, "plain_ms": pms, "bytes": nbytes,
                "bound_ms": bound_ms(nbytes, 40 * n, PEAK_F32_FLOPS)[0], "dtype": str(dtype)[6:]}

    lora_leaf = ada_time(14336 * 64)
    big_leaf = ada_time(64 << 20)
    lora_leaf_bf16 = ada_time(14336 * 64, torch.bfloat16)
    torch.cuda.empty_cache()
    entry("optimizer_update_8bit_ademamix", lora_leaf["ms"], lora_leaf["plain_ms"], None, lora_leaf["bytes"],
          40 * lora_leaf["n"], PEAK_F32_FLOPS, 0.0, shape=[14336, 64], rule="ademamix, step 5, scheduled, decay",
          cases=checks, leaf_64M=big_leaf, bf16_params=lora_leaf_bf16,
          note="library_ms is null: no PyTorch call computes AdEMAMix; bit-identical in every case checked")

    # a CUDA input the kernels cannot take raises; it never reaches a plain version
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    b64, am64 = torch.zeros(64, dtype=torch.uint8, device=dev), torch.ones(2, device=dev)  # a [2, 64] payload, bs 64
    q96 = torch.zeros(1, 1, 1, 96, dtype=torch.bfloat16, device=dev)
    s1 = torch.ones(1, 1, 1, device=dev)
    bad = {
        "cached hd 96": lambda: flash_attention_cached(q96, q96, q96, z, T=1),
        "cached int8 hd 96": lambda: flash_attention_cached(q96, q96.to(torch.int8), q96.to(torch.int8), z, T=1,
                                                            k_scale=s1, v_scale=s1),
        "paged hd 96": lambda: flash_attention_paged(q96, q96.expand(2, 1, 16, 96).contiguous(),
                                                     q96.expand(2, 1, 16, 96).contiguous(), z[None], z),
        "paged BS 4": lambda: flash_attention_paged(q1[:1, :1], kc[:2, :1, :4].contiguous(),
                                                    vc[:2, :1, :4].contiguous(), z[None], z),
        "k9 misaligned A": lambda: gemm_4bit_fused(
            torch.zeros(65, dtype=torch.bfloat16, device=dev)[1:].reshape(1, 64), b64, am64, code, 64, (2, 64)),
        "k9 K % blocksize": lambda: gemm_4bit_fused(torch.zeros(1, 96, dtype=torch.bfloat16, device=dev),
                                                    b64[:48].contiguous(), am64, code, 64, (1, 96)),
        "k9 int8 A": lambda: gemm_4bit_fused(torch.zeros(1, 64, dtype=torch.int8, device=dev), b64, am64, code, 64,
                                             (2, 64)),
        "k9 misaligned payload": lambda: gemm_4bit_fused(torch.zeros(1, 64, dtype=torch.bfloat16, device=dev),
                                                         torch.zeros(65, dtype=torch.uint8, device=dev)[1:], am64,
                                                         code, 64, (2, 64)),
        "k10 absmax count": lambda: dequantize_4bit_2d(b64, am64[:1].contiguous(), code, 64, (2, 64)),
        "k10 float64 out": lambda: dequantize_4bit_2d(b64, am64, code, 64, (2, 64), torch.float64),
        "k11 f32 out for bf16 g": lambda: gemm_4bit_nt_fused(torch.zeros(1, 2, dtype=torch.bfloat16, device=dev), b64,
                                                             am64, code, 64, (2, 64), out_dtype=torch.float32),
        "k15 misaligned g": lambda: optimizer_update_8bit_(
            ada_scalars(1, 0.0, False), torch.zeros(4097, device=dev)[1:], torch.zeros(4096, device=dev),
            torch.zeros(2, 4096, dtype=torch.uint8, device=dev), torch.zeros(4096, dtype=torch.uint8, device=dev),
            torch.zeros(2, 16, device=dev), torch.zeros(16, device=dev), codes_a),
        "k15 state1 size": lambda: optimizer_update_8bit_(
            ada_scalars(1, 0.0, False), torch.zeros(4096, device=dev), torch.zeros(4096, device=dev),
            torch.zeros(4096, dtype=torch.uint8, device=dev), torch.zeros(4096, dtype=torch.uint8, device=dev),
            torch.zeros(2, 16, device=dev), torch.zeros(16, device=dev), codes_a),
    }
    for what, fn in bad.items():
        try:
            fn()
        except ValueError:
            continue
        raise AssertionError(f"{what}: a CUDA input the kernel cannot take did not raise")
    emit("unsupported_inputs_raise", cases=list(bad))
    del kc, vc, k8, v8, ks8, vs8, kd, vd, q1, q_pre
    torch.cuda.empty_cache()

    # -- 4. the serving paths at full width -------------------------------
    steps, prompt, batch, max_len = 32, 128, 8, 1024
    assert batch * prompt >= G.LARGE_M_THRESHOLD > batch, "prefill must take the dequant route, decode the GEMM"
    Lyr = cfg.num_layers

    def combines(rows, GT, S_):
        """Launches of the split combine that one cached-attention call of
        ``rows`` slots, ``GT`` folded rows and ``S_`` positions adds."""
        return int(FC.flash_splits(rows * KVH, GT, S_, sms)[1] > 1)

    serve_combines = Lyr * (steps * combines(batch, Gq, max_len) + combines(batch, Gq * prompt, max_len))
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device=dev)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def self_dev_us(e):  # named self_cuda_time_total before torch 2.4
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def device_events(prof):
        """Device-side events only (kernels, memcpy, memset): an operator's
        own entry repeats the time of the kernels it launched, and a user
        annotation (``Optimizer.step``) spans them on the device's timeline."""
        return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and self_dev_us(e) > 0
                and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]

    def quantize_2d(layer):
        """A fused layer as the FSDP-QLoRA recipe stores it: bf16
        quant_storage (so the K-adjacent "2d" layout), NF4 blocksize 64,
        double-quantized; wqkv and gate_up concatenated as
        ``quantize_params_4bit(fuse=True)`` concatenates them."""
        def q(W):
            return QuantizedTensor.quantize(W.to(torch.float32), blocksize=64, quant_type="nf4",
                                            compress_statistics=True, quant_storage=torch.bfloat16)

        return {"attn_norm": layer["attn_norm"], "mlp_norm": layer["mlp_norm"],
                "wqkv": q(torch.cat([layer["wq"], layer["wk"], layer["wv"]], dim=0)), "wo": q(layer["wo"]),
                "gate_up": q(torch.cat([layer["gate"], layer["up"]], dim=0)), "down": q(layer["down"])}

    def serve(tag, compress, expected, keep=False, quantize=None):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # what earlier phases still hold
        t0 = time.perf_counter()
        params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0

        reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(cfg.num_layers):  # frees each layer's bf16 weights as it goes
            params["layers"][i] = quantize(params["layers"][i]) if quantize else L.quantize_params_4bit(
                {"layers": [params["layers"][i]]}, fuse=True, compress_statistics=compress)["layers"][0]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        init_peak = torch.cuda.max_memory_allocated()  # the bf16 weights before quantizing
        resident = torch.cuda.memory_allocated() - held  # the quantized model
        torch.cuda.reset_peak_memory_stats()
        cache = L.init_kv_cache(cfg, batch, max_len, device=dev)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = L.prefill(params, ids, cfg, cache)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        assert logits.shape == (batch, prompt, cfg.vocab_size) and torch.isfinite(logits).all()

        step_ms, tokens = [], [tok]
        for s in range(steps):
            t0 = time.perf_counter()
            logits, cache = L.decode_step(params, tok, cfg, cache, prompt + s)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            tokens.append(tok)
        counts = launch_counts()
        assert logits.shape == (batch, cfg.vocab_size) and torch.isfinite(logits).all()
        toks = torch.stack(tokens, 1)
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        want = {k: 0 for k in counts}
        want.update(expected)
        assert counts == want, f"{tag}: launch counts {counts} != {want}"

        # device busy share over 4 more decode steps (after the counts are read)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for s in range(4):
                logits, cache = L.decode_step(params, tok, cfg, cache, prompt + steps + s)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        dev_us = sum(self_dev_us(e) for e in events)
        attn_us = sum(self_dev_us(e) for e in events if "flash" in e.key)  # kernels 4 and 16 and their combine
        top = sorted(((e.key, self_dev_us(e) / 4e3, e.count // 4) for e in events), key=lambda r: -r[1])[:8]

        med = statistics.median(step_ms)
        scale_bytes = (lambda N, K: (K // bs) * N + -(-N * (K // bs) // 256) * 4 + 4) if compress else \
            (lambda N, K: (K // bs) * N * 4)
        wbytes = Lyr * sum(N * K // 2 + scale_bytes(N, K) for N, K in LINEARS.values())
        head_bytes = cfg.vocab_size * cfg.hidden_size * 2
        kv_bytes = Lyr * 2 * batch * KVH * hd * 2 * (prompt + steps // 2)
        step_bytes = wbytes + head_bytes + kv_bytes
        emit(
            tag, config="llama3_8b", compress_statistics=compress, layers=Lyr, batch=batch, prompt=prompt,
            steps=steps, init_s=init_s, load_s=load_s, prefill_ms=prefill_ms,
            decode_ms={"median": med, "min": min(step_ms), "max": max(step_ms), "n": steps},
            tok_s=batch / (med * 1e-3), step_bytes=step_bytes,
            step_bound_ms_canary=step_bytes / canary_bs * 1e3,
            step_bound_ms_peak=step_bytes / PEAK_BYTES_S * 1e3,
            max_memory_allocated=max(init_peak, torch.cuda.max_memory_allocated()),
            resident_after_load=resident, held_before_load=held, serving_peak_memory=torch.cuda.max_memory_allocated(),
            launches=counts,
            profiled_decode={"steps": 4, "wall_ms_per_step": prof_wall_ms / 4,
                             "device_ms_per_step": dev_us / 4e3,
                             "attention_ms_per_step": attn_us / 4e3, "attention_share": attn_us / max(dev_us, 1),
                             "device_busy_share": dev_us / 1e3 / prof_wall_ms,
                             "top_kernels_ms_per_step": top},
            first_tokens=toks[0, :8].tolist(), layout="2d, bf16 quant_storage" if quantize else "paired",
        )
        del cache, logits
        if not keep:
            del params
            params = None
        torch.cuda.empty_cache()
        return counts, params

    # 4a. NF4 (the model is kept for the engine, 4e)
    counts, nf4_params = serve("serve", False, {
        "quantize_4bit_codes": 4 * Lyr,
        "dequantize_paired_fast": 4 * Lyr,
        "gemm_4bit_paired": 4 * Lyr * steps,
        "flash_attention_cached": Lyr * (steps + 1),
        "flash_attention_combine": serve_combines,
    }, keep=True)
    for name in ("quantize_4bit_codes", "gemm_4bit_paired", "dequantize_paired_fast", "flash_attention_cached",
                 "flash_attention_combine"):
        report[name]["launches"] = counts[name]

    # 4b. NF4 with the absmax double-quantized: the _dq kernels, never kernels 2/3
    counts, nested_params = serve("serve_nested", True, {
        "quantize_4bit_codes": 4 * Lyr,
        "quantize_blockwise8": 4 * Lyr,
        "dequantize_paired_fast_dq": 4 * Lyr,
        "gemm_4bit_paired_dq": 4 * Lyr * steps,
        "flash_attention_cached": Lyr * (steps + 1),
        "flash_attention_combine": serve_combines,
    }, keep=True)
    for name in ("gemm_4bit_paired_dq", "dequantize_paired_fast_dq", "quantize_blockwise8"):
        report[name]["launches"] = counts[name]

    # 4c. the blockwise 8-bit round trip, nested, of an lm_head-sized tensor
    xl = torch.randn(32000, 4096, generator=gen, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    q8, s8 = FB.quantize_blockwise(xl, blocksize=4096, nested=True)
    back = FB.dequantize_blockwise(q8, s8)
    torch.cuda.synchronize()
    rt_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want.update({"quantize_blockwise8": 2, "dequantize_blockwise8": 1})
    assert counts == want, f"blockwise round trip: launch counts {counts} != {want}"
    assert q8.dtype == torch.uint8 and back.shape == xl.shape and torch.isfinite(back).all()
    # each element within half the widest gap of the dynamic map times its
    # block's absmax, plus the error of the double-quantized absmax itself
    am8 = xl.reshape(-1, 4096).abs().amax(1)
    gap = float((dyn[1:].astype("float64") - dyn[:-1]).max())
    bound = (gap / 2 * am8 + (s8.dequant_absmax() - am8).abs())[:, None]
    err = ((back - xl).reshape(-1, 4096).abs() / bound).max().item()
    assert err <= 1.001, f"blockwise round trip error {err} of its bound"
    report["dequantize_blockwise8"]["launches"] = counts["dequantize_blockwise8"]
    emit("blockwise8_round_trip", shape=[32000, 4096], blocksize=4096, nested=True, wall_ms=rt_ms,
         launches=counts, max_err_over_bound=err, code_bytes=q8.numel(),
         absmax_bytes=s8.absmax.numel() + s8.state2.absmax.numel() * 4 + 4)
    del xl, q8, s8, back, am8
    torch.cuda.empty_cache()

    # -- 4d. QLoRA training at full width, on 4b's double-quantized model --
    rank, alpha, tb, tt, tsteps, chunk = 64, 16.0, 4, 512, 5, 512
    assert tb * tt >= G.LARGE_M_THRESHOLD and tb * tt >= G.BACKWARD_LARGE_M_THRESHOLD
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lora = L.add_lora(cfg, rank=rank, alpha=alpha, targets=LORA_TARGETS,
                      generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    lparams = L.lora_parameters(lora)
    n_adapter = sum(t.numel() for t in lparams if t.dim() > 0)
    opt = O.adamw8bit(lparams, 1e-3)
    tids = torch.randint(0, cfg.vocab_size, (tb, tt + 1), generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt_ms = []
    opt_step = opt.step

    def timed_step(*a, **k):  # the optimizer's share of lora_train_step, host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = opt_step(*a, **k)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    opt.step = timed_step
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, train_ms = [], []
    for _ in range(tsteps):
        t0 = time.perf_counter()
        loss = L.lora_train_step(nested_params, lora, opt, tids, cfg, token_chunk=chunk)
        losses.append(loss.item())  # synchronizes
        train_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    want = {k: 0 for k in counts}
    # forward: 4 dequantizes a layer; backward: 4 a layer but layer 0's wqkv,
    # whose input needs no gradient; one update per adapter tensor a step
    want.update({"dequantize_paired_fast_dq": tsteps * (8 * Lyr - 1),
                 "optimizer_update_8bit": tsteps * 2 * len(LORA_TARGETS) * Lyr})
    assert counts == want, f"qlora train: launch counts {counts} != {want}"
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0], f"qlora losses {losses}"
    states = [opt.state[t] for t in lparams if t.dim() > 0]
    assert all(st["state1"].dtype == torch.uint8 for st in states), "every adapter tensor keeps 8-bit states"
    train_peak = torch.cuda.max_memory_allocated()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        L.lora_train_step(nested_params, lora, opt, tids, cfg, token_chunk=chunk).item()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    dev_us = sum(self_dev_us(e) for e in events)
    top = sorted(((e.key[:120], self_dev_us(e) / 1e3, e.count) for e in events), key=lambda r: -r[1])[:12]
    dq_us = sum(self_dev_us(e) for e in events if "dequantize_paired" in e.key)
    med = statistics.median(train_ms[1:])
    emit("qlora_train", config="llama3_8b", layers=Lyr, compress_statistics=True, lora_rank=rank,
         lora_alpha=alpha, targets=list(LORA_TARGETS), adapter_params=n_adapter, optimizer="adamw8bit",
         lr=1e-3, batch=tb, seq=tt, tokens_per_step=tb * tt, token_chunk=chunk, steps=tsteps, losses=losses,
         step_ms={"median_2_5": med, "all": train_ms}, tokens_per_s=tb * tt / (med * 1e-3),
         optimizer_ms={"median_2_5": statistics.median(opt_ms[1:tsteps]), "all": opt_ms[:tsteps]},
         peak_memory=train_peak, launches=counts,
         launches_per_step={k: v / tsteps for k, v in counts.items() if v},
         profiled_step={"wall_ms": prof_wall_ms, "device_ms": dev_us / 1e3,
                        "device_busy_share": dev_us / 1e3 / prof_wall_ms,
                        "dequantize_ms": dq_us / 1e3, "dequantize_share_of_device": dq_us / dev_us,
                        "top_kernels_ms": top})
    report["optimizer_update_8bit"]["launches"] = counts["optimizer_update_8bit"]
    opt.step = opt_step
    del lora, lparams, opt, states, nested_params, tids, loss, prof
    torch.cuda.empty_cache()

    # -- 4e. the continuous-batching engine at full width, on 4a's model ----
    def engine_run(eng, submit):
        """Drive ``eng`` through the requests ``submit(eng)`` adds, with the
        launch counts zeroed just before.  Returns the results, the counts,
        the (rows, padded length) of every prefill call, the decode steps
        dispatched and the wall seconds."""
        prefills, orig = [], E._prefill_batch

        def counted(params, cache_n, ids, *a, **k):
            prefills.append(tuple(ids.shape))
            return orig(params, cache_n, ids, *a, **k)

        E._prefill_batch = counted
        try:
            torch.cuda.synchronize()
            chunks0 = eng._step_count
            reset_launch_counts()
            t0 = time.perf_counter()
            submit(eng)
            results = []
            while eng.has_work():
                results.extend(eng.step())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            E._prefill_batch = orig
        return results, counts, prefills, (eng._step_count - chunks0) * eng.steps_per_sync, wall

    def engine_expected(layers, prefills, dsteps, kv_dtype, layout, max_batch, max_len_):
        """Launches of an engine run: 4 linears a layer per decode step (M =
        max_batch, kernel 2) and per prefill call (kernel 3 from M = 32);
        the cached attention ceil(pad / (GT_MAX / G)) times a layer per
        prefill; one decode attention a layer per decode step; the split
        combine after each attention call whose grid is split (a paged
        engine prefills through a dense cache of the padded length)."""
        sfx = "_int8" if kv_dtype == "int8" else ""
        want = {k: 0 for k in launch_counts()}
        want["gemm_4bit_paired"] = 4 * layers * dsteps
        tc = GT_MAX // Gq
        for rows, pad in prefills:
            want["dequantize_paired_fast" if rows * pad >= G.LARGE_M_THRESHOLD else "gemm_4bit_paired"] += 4 * layers
            want["flash_attention_cached" + sfx] += layers * -(-pad // tc)
            for off in range(0, pad, tc):
                want["flash_attention_combine"] += layers * combines(
                    rows, Gq * min(tc, pad - off), pad if layout == "paged" else max_len_)
        want[("flash_attention_paged" if layout == "paged" else "flash_attention_cached") + sfx] += layers * dsteps
        want["flash_attention_combine"] += layers * dsteps * combines(max_batch, Gq, max_len_)
        return want

    n_req, new_tok, mb, ml, bs_e, nb_e = 48, 64, 16, 1024, 128, 96
    assert mb < G.LARGE_M_THRESHOLD, "decode must take kernel 2"
    g1 = torch.Generator().manual_seed(1)
    plens = torch.randint(32, 769, (n_req,), generator=g1).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g1).tolist() for n in plens]

    def make_engine():
        return ContinuousBatchingEngine(nf4_params, cfg, max_batch=mb, max_len=ml, kv_dtype="int8", kv_layout="paged",
                                        kv_block_size=bs_e, num_kv_blocks=nb_e, steps_per_sync=8, pipeline_depth=2,
                                        seed=0)

    make_engine().generate(prompts[:2], max_new_tokens=8)  # warm-up (cuBLAS, allocator), before the counts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = make_engine()

    def submit(e):  # every other request sampled, the rest greedy
        for i, p in enumerate(prompts):
            e.add_request(p, max_new_tokens=new_tok, temperature=0.8 if i % 2 else 0.0, top_p=0.95 if i % 2 else 1.0)

    results, counts, prefills, dsteps, wall = engine_run(eng, submit)
    engine_peak = torch.cuda.max_memory_allocated()
    assert len(results) == n_req and all(len(r.tokens) == new_tok and r.finished_reason == "length"
                                         for r in results), "every request finishes with its tokens"
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.tokens)
    assert sorted(eng._free_blocks) == list(range(nb_e)) and not eng._slot_blocks and not eng.slots, \
        "every block returns to the free list"
    want = engine_expected(Lyr, prefills, dsteps, "int8", "paged", mb, ml)
    assert counts == want, f"engine: launch counts {counts} != {want}"
    for name in ("flash_attention_cached_int8", "flash_attention_paged_int8"):
        report[name]["launches"] = counts[name]
    pool_bytes = sum(t.numel() * t.element_size() for t in eng.cache[:4])
    preempts = eng.preempt_count
    del eng

    # one decode chunk profiled, in a second run after the counts are read:
    # 16 requests of 128 prompt tokens; three steps admit them and leave
    # one chunk in flight, which the synchronize finishes before the window
    eng = make_engine()
    for p in prompts[:mb]:
        eng.add_request(p[:128], max_new_tokens=new_tok)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()  # the same work without the profiler: one chunk dispatched and run, the one before read
    torch.cuda.synchronize()
    chunk_wall_plain = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()  # dispatches one chunk of 8 decode steps and reads the finished one
        torch.cuda.synchronize()
        chunk_wall = (time.perf_counter() - t0) * 1e3
    while eng.has_work():
        eng.step()
    events = device_events(prof)
    chunk_dev = sum(self_dev_us(e) for e in events) / 1e3
    chunk_attn = sum(self_dev_us(e) for e in events if "flash" in e.key) / 1e3
    top = sorted(((e.key[:100], self_dev_us(e) / 1e3, e.count) for e in events), key=lambda r: -r[1])[:10]
    ttft = [r.ttft_s for r in results]
    emit("engine", config="llama3_8b", layers=Lyr, kv_dtype="int8", kv_layout="paged", kv_block_size=bs_e,
         max_batch=mb, max_len=ml, num_kv_blocks=nb_e, steps_per_sync=8, pipeline_depth=2, requests=n_req,
         prompt_tokens={"min": min(plens), "max": max(plens), "sum": sum(plens)}, new_tokens=new_tok,
         sampled=n_req // 2, sampling={"temperature": 0.8, "top_p": 0.95}, wall_s=wall,
         generated_tok_s=n_req * new_tok / wall,
         ttft_s={"p50": statistics.median(ttft), "p95": statistics.quantiles(ttft, n=20)[18]},
         total_s={"p50": statistics.median(r.total_s for r in results)},
         decode_chunks=dsteps // 8, decode_steps=dsteps, prefill_calls=len(prefills), prefills=prefills,
         preempt_count=preempts, kv_pool_bytes=pool_bytes,
         dense_bf16_kv_bytes=2 * Lyr * mb * KVH * ml * hd * 2, peak_memory=engine_peak, launches=counts,
         profiled_chunk={"decode_steps": 8, "wall_ms": chunk_wall, "device_ms": chunk_dev,
                         "attention_ms": chunk_attn, "attention_share": chunk_attn / chunk_dev,
                         "device_busy_share": chunk_dev / chunk_wall, "wall_ms_unprofiled": chunk_wall_plain,
                         "device_busy_share_unprofiled": chunk_dev / chunk_wall_plain, "top_kernels_ms": top},
         note="all 48 requests arrive at once, so TTFT includes the wait for a slot")
    del eng, prof
    torch.cuda.empty_cache()

    # the same engine over a bf16 pool (kv_layout="paged" at the default
    # kv_dtype): kernel 16's bf16 mode and kernel 4 bf16 in the prefills.
    # The last request's prompt leaves 20 positions of max_len, so its last
    # decode chunks run past the cache's end (those writes are dropped).
    n_bf, new_bf, near = 16, 32, ml - 20
    prompts_bf = prompts[: n_bf - 1] + [
        torch.randint(0, cfg.vocab_size, (near,), generator=torch.Generator().manual_seed(2)).tolist()]
    eng = ContinuousBatchingEngine(nf4_params, cfg, max_batch=mb, max_len=ml, kv_dtype="bf16", kv_layout="paged",
                                   kv_block_size=bs_e, steps_per_sync=8, pipeline_depth=2, seed=0)
    results_bf, counts, prefills_bf, dsteps_bf, wall_bf = engine_run(
        eng, lambda e: [e.add_request(p, max_new_tokens=new_bf) for p in prompts_bf])
    results_bf.sort(key=lambda r: r.request_id)
    assert len(results_bf) == n_bf and all(r.finished_reason == "length" for r in results_bf)
    assert [len(r.tokens) for r in results_bf] == [new_bf] * (n_bf - 1) + [ml - near], "the tokens up to max_len"
    assert sorted(eng._free_blocks) == list(range(eng.num_kv_blocks)) and not eng._slot_blocks, \
        "every block returns to the free list"
    want = engine_expected(Lyr, prefills_bf, dsteps_bf, "bf16", "paged", mb, ml)
    assert counts == want, f"engine bf16: launch counts {counts} != {want}"
    report["flash_attention_paged"]["launches"] = counts["flash_attention_paged"]
    emit("engine_bf16", config="llama3_8b", layers=Lyr, kv_dtype="bf16", kv_layout="paged", kv_block_size=bs_e,
         max_batch=mb, max_len=ml, num_kv_blocks=eng.num_kv_blocks, steps_per_sync=8, pipeline_depth=2,
         requests=n_bf, prompt_tokens=[len(p) for p in prompts_bf], new_tokens=new_bf, wall_s=wall_bf,
         generated_tok_s=sum(len(r.tokens) for r in results_bf) / wall_bf, decode_steps=dsteps_bf,
         prefills=prefills_bf, max_len_request_tokens=len(results_bf[-1].tokens),
         kv_pool_bytes=sum(t.numel() * t.element_size() for t in eng.cache[:2]), launches=counts)
    del eng, nf4_params
    torch.cuda.empty_cache()

    # -- 4f. serve, then QLoRA-train with AdEMAMix, on bf16 quant_storage ---
    # (the K-adjacent layout: kernels 9 and 10, the nested absmax decoded on
    # the device before each call, then kernels 10 and 15 in training)
    assert batch < G.LARGE_M_THRESHOLD <= batch * prompt and tb * tt >= G.BACKWARD_LARGE_M_THRESHOLD
    counts, kq_params = serve("serve_kadjacent", True, {
        "quantize_4bit_codes": 4 * Lyr,
        "quantize_blockwise8": 4 * Lyr,
        "dequantize_4bit_2d": 4 * Lyr,
        "gemm_4bit_fused": 4 * Lyr * steps,
        "flash_attention_cached": Lyr * (steps + 1),
        "flash_attention_combine": serve_combines,
    }, keep=True, quantize=quantize_2d)
    report["gemm_4bit_fused"]["launches"] = counts["gemm_4bit_fused"]
    st0 = kq_params["layers"][0]["gate_up"].state
    assert st0.layout == "2d" and st0.nested and kq_params["layers"][0]["gate_up"].data.dtype == torch.uint16
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st0.dequant_absmax()
        torch.cuda.synchronize()
    decode_launches = sum(e.count for e in device_events(prof))  # PyTorch's kernels, none of the port's

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lora = L.add_lora(cfg, rank=rank, alpha=alpha, targets=LORA_TARGETS,
                      generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    lparams = L.lora_parameters(lora)
    opt = O.ademamix8bit(lparams, lr=1e-3, t_alpha=1000, t_beta3=1000)
    tids = torch.randint(0, cfg.vocab_size, (tb, tt + 1), generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt_ms = []
    opt_step = opt.step
    opt.step = timed_step
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, train_ms = [], []
    for _ in range(tsteps):
        t0 = time.perf_counter()
        loss = L.lora_train_step(kq_params, lora, opt, tids, cfg, token_chunk=chunk)
        losses.append(loss.item())  # synchronizes
        train_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want.update({"dequantize_4bit_2d": tsteps * (8 * Lyr - 1),
                 "optimizer_update_8bit_ademamix": tsteps * 2 * len(LORA_TARGETS) * Lyr})
    assert counts == want, f"qlora ademamix train: launch counts {counts} != {want}"
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0], f"qlora losses {losses}"
    states = [opt.state[t] for t in lparams if t.dim() > 0]
    assert all(st["state1"].dtype == torch.uint8 and st["state1"].shape[0] == 2 for st in states)
    train_peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        L.lora_train_step(kq_params, lora, opt, tids, cfg, token_chunk=chunk).item()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    dev_us = sum(self_dev_us(e) for e in events)

    def kclass(key):
        if "dequantize_4bit_2d" in key:
            return "kernel 10 (dequantize_4bit_2d)"
        if "ademamix" in key:
            return "kernel 15 (AdEMAMix update)"
        if any(w in key.lower() for w in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
            return "GEMM (cuBLAS)"
        if "copy" in key.lower() or "cast" in key.lower():
            return "copies and casts"
        return "other PyTorch kernels"

    by_class = {}
    for e in events:
        c = by_class.setdefault(kclass(e.key), {"ms": 0.0, "launches": 0})
        c["ms"] += self_dev_us(e) / 1e3
        c["launches"] += e.count
    top = sorted(((e.key[:120], self_dev_us(e) / 1e3, e.count) for e in events), key=lambda r: -r[1])[:12]
    med = statistics.median(train_ms[1:])
    emit("qlora_train_ademamix", config="llama3_8b", layers=Lyr, layout="2d, bf16 quant_storage",
         compress_statistics=True, lora_rank=rank, lora_alpha=alpha, targets=list(LORA_TARGETS),
         optimizer="ademamix8bit", lr=1e-3, t_alpha=1000, t_beta3=1000, batch=tb, seq=tt,
         tokens_per_step=tb * tt, token_chunk=chunk, steps=tsteps, losses=losses,
         step_ms={"median_2_5": med, "all": train_ms}, tokens_per_s=tb * tt / (med * 1e-3),
         optimizer_ms={"median_2_5": statistics.median(opt_ms[1:tsteps]), "all": opt_ms[:tsteps]},
         peak_memory=train_peak, launches=counts, launches_per_step={k: v / tsteps for k, v in counts.items() if v},
         nested_decode_launches_per_call=decode_launches,
         profiled_step={"wall_ms": prof_wall_ms, "device_ms": dev_us / 1e3,
                        "device_busy_share": dev_us / 1e3 / prof_wall_ms, "by_class": by_class,
                        "top_kernels_ms": top})
    for name in ("dequantize_4bit_2d", "optimizer_update_8bit_ademamix"):
        report[name]["launches"] = counts[name]
    opt.step = opt_step
    del lora, lparams, opt, states, kq_params, tids, loss, prof
    torch.cuda.empty_cache()

    # -- 5. both paths on the card and on the CPU, 2 layers ----------------
    cfg2 = L.LlamaConfig.llama3_8b(num_layers=2)
    cpu_float = L.init_params(cfg2, torch.Generator().manual_seed(7), device="cpu")

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_dev(v) for v in tree]
        return tree.to(dev)

    B2, T2, steps2 = 2, 64, 4
    ids2 = torch.randint(0, cfg2.vocab_size, (B2, T2), generator=torch.Generator().manual_seed(8))
    for compress in (False, True):
        gpu_params = L.quantize_params_4bit(to_dev(cpu_float), fuse=True, compress_statistics=compress)
        cpu_params = L.quantize_params_4bit(cpu_float, fuse=True, compress_statistics=compress)
        for lc, lg in zip(cpu_params["layers"], gpu_params["layers"]):
            for name in ("wqkv", "wo", "gate_up", "down"):
                sc, sg = lc[name].state, lg[name].state
                assert torch.equal(lc[name].data, lg[name].data.cpu()), f"quantized bytes differ: {name}"
                assert torch.equal(sc.absmax, sg.absmax.cpu()), name
                if compress:
                    assert sg.inline_nested and torch.equal(sc.offset, sg.offset.cpu()), f"offset: {name}"
                    assert torch.equal(sc.state2.absmax, sg.state2.absmax.cpu()), f"state2.absmax: {name}"
        gcache = L.init_kv_cache(cfg2, B2, 256, device=dev)
        ccache = L.init_kv_cache(cfg2, B2, 256, device="cpu")
        glog, gcache = L.prefill(gpu_params, ids2.to(dev), cfg2, gcache)
        clog, ccache = L.prefill(cpu_params, ids2, cfg2, ccache)
        pairs = [(glog[:, -1].cpu(), clog[:, -1])]
        tok = glog[:, -1].argmax(-1)
        for s in range(steps2):
            glog, gcache = L.decode_step(gpu_params, tok, cfg2, gcache, T2 + s)
            clog, ccache = L.decode_step(cpu_params, tok.cpu(), cfg2, ccache, T2 + s)  # teacher-forced
            pairs.append((glog.cpu(), clog))
            tok = glog.argmax(-1)
        worst = 0.0
        for step, (g, c) in enumerate(pairs):
            assert torch.allclose(g, c, atol=0.1, rtol=0.05), f"logits differ at step {step}"
            worst = max(worst, (g - c).abs().max().item())
            top5 = c.topk(5, dim=-1).indices
            assert (top5 == g.argmax(-1, keepdim=True)).any(-1).all(), f"greedy token outside top-5 at step {step}"
        emit("cpu_check_nested" if compress else "cpu_check", layers=2, batch=B2, prompt=T2, steps=steps2,
             compress_statistics=compress, max_abs_logit_diff=worst,
             prefill_route="dequant+matmul" if B2 * T2 >= G.LARGE_M_THRESHOLD else "gemm kernel")
        del gpu_params, cpu_params, gcache, ccache
        torch.cuda.empty_cache()

    # -- 5b. one QLoRA step at 2 layers, card against CPU, M = 16 ---------
    B5, T5 = 2, 8  # ids [2, 9]: the small-M routes, kernels 2/5 forward and 7/8 backward
    assert B5 * T5 < G.LARGE_M_THRESHOLD and B5 * T5 < G.BACKWARD_LARGE_M_THRESHOLD
    ids5 = torch.randint(0, cfg2.vocab_size, (B5, T5 + 1), generator=torch.Generator().manual_seed(9))
    lora0 = L.add_lora(cfg2, rank=64, alpha=16.0, targets=LORA_TARGETS,
                       generator=torch.Generator().manual_seed(10), device="cpu")
    g5 = torch.Generator().manual_seed(11)
    for layer in lora0["layers"]:  # b non-zero, so that every adapter tensor has a gradient
        for ad in layer.values():
            ad["b"] = (torch.randn(ad["b"].shape, generator=g5) * 0.02).requires_grad_()

    def fresh(device):  # a copy: the CPU's step must not move lora0
        return {"layers": [{n: {k: t.detach().clone().to(device).requires_grad_() for k, t in ad.items()}
                            for n, ad in layer.items()} for layer in lora0["layers"]]}

    for compress in (False, True):
        gpu_params = L.quantize_params_4bit(to_dev(cpu_float), fuse=True, compress_statistics=compress)
        cpu_params = L.quantize_params_4bit(cpu_float, fuse=True, compress_statistics=compress)
        lg = fresh(dev)
        og = O.adamw8bit(L.lora_parameters(lg), 1e-3)
        torch.cuda.synchronize()
        reset_launch_counts()
        loss_g = L.lora_train_step(gpu_params, lg, og, ids5.to(dev), cfg2).item()
        counts = launch_counts()
        sfx = "_dq" if compress else ""
        want = {k: 0 for k in counts}
        want.update({f"gemm_4bit_paired{sfx}": 4 * 2, f"gemm_4bit_paired_nt{sfx}": 4 * 2 - 1,
                     "optimizer_update_8bit": 2 * len(LORA_TARGETS) * 2})
        assert counts == want, f"qlora 2-layer step: launch counts {counts} != {want}"
        report[f"gemm_4bit_paired_nt{sfx}"]["launches"] = counts[f"gemm_4bit_paired_nt{sfx}"]

        lc = fresh("cpu")
        loss_c = L.lm_loss(cpu_params, lc, ids5, cfg2)
        loss_c.backward()
        assert abs(loss_g - loss_c.item()) <= 1e-3 * abs(loss_c.item()), f"2-layer loss {loss_g} vs {loss_c.item()}"
        grad_err = 0.0
        for tg, tc in zip(L.lora_parameters(lg), L.lora_parameters(lc)):
            a, b = tg.grad.cpu(), tc.grad
            assert torch.allclose(a, b, rtol=2e-2, atol=2e-3), "adapter gradients differ from the CPU's"
            grad_err = max(grad_err, (a - b).abs().max().item())
        # the CPU's optimizer step on the card's gradients: the same adapters and states
        lc2 = fresh("cpu")
        oc = O.adamw8bit(L.lora_parameters(lc2), 1e-3)
        for tc, tg in zip(L.lora_parameters(lc2), L.lora_parameters(lg)):
            tc.grad = tg.grad.cpu()
        oc.step()
        p_err, n8 = 0.0, 0
        for tc, tg in zip(L.lora_parameters(lc2), L.lora_parameters(lg)):
            p_err = max(p_err, (tc.detach() - tg.detach().cpu()).abs().max().item())
            sc, sg = oc.state[tc], og.state[tg]
            for key in sc:
                if key == "step":
                    continue
                if sc[key].dtype == torch.uint8:
                    n8 += 1
                    assert torch.equal(sc[key], sg[key].cpu()), f"8-bit state {key} differs from the CPU's"
                else:
                    assert torch.allclose(sc[key], sg[key].cpu(), rtol=1e-6, atol=0), f"state {key}"
        assert p_err <= 1e-6 and n8 > 0, f"adapters {p_err} from the CPU's"
        emit("cpu_check_qlora" + ("_nested" if compress else ""), layers=2, batch=B5, seq=T5, lora_rank=64,
             compress_statistics=compress, loss_card=loss_g, loss_cpu=loss_c.item(),
             max_abs_grad_diff=grad_err, max_abs_adapter_diff=p_err, states_8bit_equal=n8, launches=counts)
        del gpu_params, cpu_params, lg, og, lc, lc2, oc
        torch.cuda.empty_cache()

    # -- 5c. the engine at 2 layers, card against CPU ----------------------
    g5c = torch.Generator().manual_seed(12)
    prompts5 = [torch.randint(0, cfg2.vocab_size, (n,), generator=g5c).tolist() for n in (20, 33, 50)]
    pad5, new5, ml5, bs5 = 64, 6, 128, 16
    assert all(E._bucket(len(p)) == pad5 for p in prompts5), "one prefill bucket"
    gpu_params = L.quantize_params_4bit(to_dev(cpu_float), fuse=True)
    cpu_params = L.quantize_params_4bit(cpu_float, fuse=True)

    def forced(params, device, kv_dtype, layout, streams):
        """Logits along each stream, teacher-forced: the prompts prefilled
        padded as the engine pads them, then per-slot decode steps through a
        dense cache or through a shuffled pool packed from the prefill."""
        n = len(prompts5)
        ids = torch.zeros(n, pad5, dtype=torch.int64)
        for i, p in enumerate(prompts5):
            ids[i, : len(p)] = torch.tensor(p)
        paged = layout == "paged"
        cache = L.init_kv_cache(cfg2, n, pad5 if paged else ml5, kv_dtype=kv_dtype, device=device)
        lg, cache = L.prefill(params, ids.to(device), cfg2, cache)
        out = [torch.stack([lg[i, len(p) - 1] for i, p in enumerate(prompts5)]).float().cpu()]
        if paged:
            per_slot, used = ml5 // bs5, pad5 // bs5
            pool = L.init_paged_kv_cache(cfg2, n, ml5, n * per_slot + 1, bs5, kv_dtype, device=device)
            perm = torch.randperm(n * per_slot + 1, generator=torch.Generator().manual_seed(13))[: n * per_slot]
            pool = pool._replace(tables=perm.reshape(n, per_slot).to(torch.int32).to(device))
            idx = pool.tables[:, :used].reshape(-1).long()
            for dst, src in zip(pool[:4], cache):  # [L, n, KVH, pad(, hd)] -> blocks [L, n*used, KVH, BS(, hd)]
                rest = tuple(src.shape[4:])
                dst[:, idx] = src.reshape(src.shape[0], n, src.shape[2], used, bs5, *rest).transpose(2, 3).reshape(
                    src.shape[0], n * used, src.shape[2], bs5, *rest)
            cache = pool
        pos = torch.tensor([len(p) for p in prompts5])
        for s in range(len(streams[0]) - 1):
            tok = torch.tensor([st[s] for st in streams])
            lg, cache = L.decode_step(params, tok.to(device), cfg2, cache, (pos + s).to(device))
            out.append(lg.float().cpu())
        return out

    cpu_ref = {}
    for kv_dtype in ("bf16", "int8"):
        for layout in ("dense", "paged"):
            eng = ContinuousBatchingEngine(gpu_params, cfg2, max_batch=4, max_len=ml5, kv_dtype=kv_dtype,
                                           kv_layout=layout, kv_block_size=bs5, steps_per_sync=4)
            results, counts, prefills, dsteps, _ = engine_run(
                eng, lambda e: [e.add_request(p, max_new_tokens=new5) for p in prompts5])
            want = engine_expected(2, prefills, dsteps, kv_dtype, layout, 4, ml5)
            assert counts == want, f"2-layer engine {kv_dtype} {layout}: launch counts {counts} != {want}"
            streams = [r.tokens for r in results]
            assert all(len(st) == new5 for st in streams)
            key = (kv_dtype, tuple(map(tuple, streams)))
            if key not in cpu_ref:
                # on the CPU the paged plain version is the dense one on the
                # gathered cache, bit for bit (tests/test_torch_flash_paged.py)
                cpu_ref[key] = forced(cpu_params, "cpu", kv_dtype, "dense", streams)
            cpu = cpu_ref[key]
            card = forced(gpu_params, dev, kv_dtype, layout, streams)
            for s in range(new5):
                top5 = cpu[s].topk(5, dim=-1).indices
                for i, st in enumerate(streams):
                    assert st[s] in top5[i].tolist(), f"2-layer engine {kv_dtype} {layout}: token {s} of stream {i}"
            assert torch.allclose(card[1], cpu[1], atol=0.1, rtol=0.05), \
                f"2-layer engine {kv_dtype} {layout}: first decode step's logits differ from the CPU's"
            emit("cpu_check_engine", layers=2, kv_dtype=kv_dtype, kv_layout=layout, kv_block_size=bs5,
                 prompts=[len(p) for p in prompts5], new_tokens=new5, streams=streams,
                 max_abs_logit_diff_decode_step_1=(card[1] - cpu[1]).abs().max().item(),
                 max_abs_logit_diff_all_steps=max((c - g).abs().max().item() for c, g in zip(cpu, card)),
                 card_argmax_equals_stream=sum(int(card[s][i].argmax()) == st[s] for s in range(new5)
                                               for i, st in enumerate(streams)) / (new5 * len(streams)),
                 launches=counts)
            del eng
    del gpu_params, cpu_params, cpu_ref
    torch.cuda.empty_cache()

    # -- 5d. 4f at 2 layers, card against CPU ------------------------------
    gpu_params = dict(to_dev(cpu_float))
    gpu_params["layers"] = [quantize_2d(layer) for layer in gpu_params["layers"]]
    cpu_params = dict(cpu_float)
    cpu_params["layers"] = [quantize_2d(layer) for layer in cpu_float["layers"]]
    for lc, lg in zip(cpu_params["layers"], gpu_params["layers"]):
        for name in ("wqkv", "wo", "gate_up", "down"):
            sc, sg = lc[name].state, lg[name].state
            assert sg.layout == "2d" and lg[name].data.dtype == torch.uint16
            assert torch.equal(lc[name].data, lg[name].data.cpu()), f"quantized bytes differ: {name}"
            assert torch.equal(sc.absmax, sg.absmax.cpu()) and torch.equal(sc.offset, sg.offset.cpu()), name
            assert torch.equal(sc.state2.absmax, sg.state2.absmax.cpu()), f"state2.absmax: {name}"
    steps5d = 2
    gcache = L.init_kv_cache(cfg2, B2, 256, device=dev)
    ccache = L.init_kv_cache(cfg2, B2, 256, device="cpu")
    torch.cuda.synchronize()
    reset_launch_counts()
    glog, gcache = L.prefill(gpu_params, ids2.to(dev), cfg2, gcache)
    clog, ccache = L.prefill(cpu_params, ids2, cfg2, ccache)
    pairs = [(glog[:, -1].cpu(), clog[:, -1])]
    tok = glog[:, -1].argmax(-1)
    for s_ in range(steps5d):
        glog, gcache = L.decode_step(gpu_params, tok, cfg2, gcache, T2 + s_)
        clog, ccache = L.decode_step(cpu_params, tok.cpu(), cfg2, ccache, T2 + s_)  # teacher-forced
        pairs.append((glog.cpu(), clog))
        tok = glog.argmax(-1)
    serve_counts = launch_counts()
    want = {k: 0 for k in serve_counts}
    want.update({"dequantize_4bit_2d": 4 * 2, "gemm_4bit_fused": 4 * 2 * steps5d,
                 "flash_attention_cached": 2 * (steps5d + 1),
                 "flash_attention_combine": 2 * (steps5d * combines(B2, Gq, 256) + combines(B2, Gq * T2, 256))})
    assert serve_counts == want, f"5d serve: launch counts {serve_counts} != {want}"
    worst = 0.0
    for step, (g, c) in enumerate(pairs):
        assert torch.allclose(g, c, atol=0.1, rtol=0.05), f"5d logits differ at step {step}"
        worst = max(worst, (g - c).abs().max().item())
        assert (c.topk(5, dim=-1).indices == g.argmax(-1, keepdim=True)).any(-1).all(), f"5d top-5 at step {step}"
    del gcache, ccache

    lg = fresh(dev)
    og = O.ademamix8bit(L.lora_parameters(lg), lr=1e-3, t_alpha=1000, t_beta3=1000)
    torch.cuda.synchronize()
    reset_launch_counts()
    loss_g = L.lora_train_step(gpu_params, lg, og, ids5.to(dev), cfg2).item()
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want.update({"gemm_4bit_fused": 4 * 2, "gemm_4bit_nt_fused": 4 * 2 - 1,
                 "optimizer_update_8bit_ademamix": 2 * len(LORA_TARGETS) * 2})
    assert counts == want, f"5d qlora step: launch counts {counts} != {want}"
    report["gemm_4bit_nt_fused"]["launches"] = counts["gemm_4bit_nt_fused"]
    lc = fresh("cpu")
    loss_c = L.lm_loss(cpu_params, lc, ids5, cfg2)
    loss_c.backward()
    assert abs(loss_g - loss_c.item()) <= 1e-3 * abs(loss_c.item()), f"5d loss {loss_g} vs {loss_c.item()}"
    grad_err = 0.0
    for tg, tc in zip(L.lora_parameters(lg), L.lora_parameters(lc)):
        a, b = tg.grad.cpu(), tc.grad
        assert torch.allclose(a, b, rtol=2e-2, atol=2e-3), "5d adapter gradients differ from the CPU's"
        grad_err = max(grad_err, (a - b).abs().max().item())
    lc2 = fresh("cpu")
    oc = O.ademamix8bit(L.lora_parameters(lc2), lr=1e-3, t_alpha=1000, t_beta3=1000)
    for tc, tg in zip(L.lora_parameters(lc2), L.lora_parameters(lg)):
        tc.grad = tg.grad.cpu()
    oc.step()
    p_err, n8 = 0.0, 0
    for tc, tg in zip(L.lora_parameters(lc2), L.lora_parameters(lg)):
        p_err = max(p_err, (tc.detach() - tg.detach().cpu()).abs().max().item())
        sc, sg = oc.state[tc], og.state[tg]
        for key in sc:
            if key == "step":
                continue
            if sc[key].dtype == torch.uint8:
                n8 += 1
                assert torch.equal(sc[key], sg[key].cpu()), f"5d 8-bit state {key} differs from the CPU's"
            else:
                assert torch.allclose(sc[key], sg[key].cpu(), rtol=1e-6, atol=0), f"5d state {key}"
    assert p_err <= 1e-6 and n8 > 0, f"5d adapters {p_err} from the CPU's"
    emit("cpu_check_kadjacent", layers=2, layout="2d, bf16 quant_storage", compress_statistics=True, batch=B2,
         prompt=T2, decode_steps=steps5d, max_abs_logit_diff=worst, serve_launches=serve_counts,
         qlora={"batch": B5, "seq": T5, "optimizer": "ademamix8bit", "loss_card": loss_g, "loss_cpu": loss_c.item(),
                "max_abs_grad_diff": grad_err, "max_abs_adapter_diff": p_err, "states_8bit_equal": n8,
                "launches": counts})
    del gpu_params, cpu_params, lg, og, lc, lc2, oc
    torch.cuda.empty_cache()

    # -- 5e. entry points that once raised on the card, against the CPU -----
    # Linear4bit with f16 and f32 compute_dtype on the paired layout, plain
    # and double-quantized, at decode M and past LARGE_M_THRESHOLD
    lin_cases = []
    N, K = LINEARS["wo"]
    Wl = torch.randn(N, K, generator=torch.Generator().manual_seed(20)) * K**-0.5
    for compress in (False, True):
        for dt in (torch.float16, torch.float32):
            lin_g = Linear4bit(K, N, bias=False, compute_dtype=dt, device=dev)
            lin_c = Linear4bit(K, N, bias=False, compute_dtype=dt, device="cpu")
            lin_g.weight = QuantizedTensor.quantize(Wl.to(dev), blocksize=bs, compress_statistics=compress)
            lin_c.weight = QuantizedTensor.quantize(Wl, blocksize=bs, compress_statistics=compress)
            assert lin_g.weight.state.layout == "paired" and lin_g.weight.state.inline_nested == compress
            sfx = "_dq" if compress else ""
            for Mx in (8, 64):
                x = torch.randn(Mx, K, generator=torch.Generator().manual_seed(Mx))
                torch.cuda.synchronize()
                reset_launch_counts()
                y = lin_g(x.to(dev))
                torch.cuda.synchronize()
                counts = launch_counts()
                kern = f"gemm_4bit_paired{sfx}" if Mx < G.LARGE_M_THRESHOLD else f"dequantize_paired_fast{sfx}"
                assert counts[kern] == 1 and sum(counts.values()) == 1, f"Linear4bit {dt} M {Mx}: {counts}"
                ref = lin_c(x)
                rel = ((y.cpu().float() - ref.float()).abs().max() / ref.float().abs().max()).item()
                assert y.dtype == dt and rel <= (1e-4 if dt == torch.float32 else 1e-2), \
                    f"Linear4bit {dt} nested {compress} M {Mx}: rel {rel}"
                lin_cases.append({"compute_dtype": str(dt)[6:], "nested": compress, "M": Mx, "kernel": kern,
                                  "rel_err_vs_cpu": rel})
            del lin_g, lin_c
    # adamw8bit and ademamix8bit over a bf16 parameter: the card's steps give the CPU's bits
    opt_cases = []
    for fname, fac, kern in (("adamw8bit", O.adamw8bit, "optimizer_update_8bit"),
                             ("ademamix8bit", lambda ps, lr: O.ademamix8bit(ps, lr, t_alpha=1000, t_beta3=1000),
                              "optimizer_update_8bit_ademamix")):
        p0 = torch.randn(14336, 64, generator=torch.Generator().manual_seed(21)).to(torch.bfloat16)
        pg, pc = torch.nn.Parameter(p0.to(dev)), torch.nn.Parameter(p0.clone())
        og, oc = fac([pg], 1e-3), fac([pc], 1e-3)
        gg = torch.Generator().manual_seed(22)
        for step in range(3):
            g = (torch.randn(p0.shape, generator=gg) * 0.01).to(torch.bfloat16)
            pg.grad, pc.grad = g.to(dev), g.clone()
            torch.cuda.synchronize()
            reset_launch_counts()
            og.step()
            torch.cuda.synchronize()
            counts = launch_counts()
            assert counts[kern] == 1 and sum(counts.values()) == 1, f"{fname}: {counts}"
            oc.step()
            assert pg.dtype == torch.bfloat16 and torch.equal(pg.detach().cpu().view(torch.int16),
                                                              pc.detach().view(torch.int16)), f"{fname} step {step}"
            for key, t in og.state[pg].items():
                if isinstance(t, torch.Tensor):
                    assert torch.equal(t.cpu(), oc.state[pc][key]), f"{fname} step {step}: {key}"
        opt_cases.append({"optimizer": fname, "param": "bf16 [14336, 64]", "steps": 3, "bit_identical": True})
        del pg, pc, og, oc
    # prefill/decode_step at head_dim 64 (tiny) and 256 (gemma_7b, 2 layers)
    hd_models = []
    for cname, cfg_x in (("tiny", L.LlamaConfig.tiny()), ("gemma_7b", L.LlamaConfig.gemma_7b(num_layers=2))):
        cpu_f = L.init_params(cfg_x, torch.Generator().manual_seed(23), device="cpu")
        gq_params = L.quantize_params_4bit(to_dev(cpu_f), fuse=True)
        cq_params = L.quantize_params_4bit(cpu_f, fuse=True)
        del cpu_f
        Bx, Tx, stx = 2, 16, 2
        idsx = torch.randint(0, cfg_x.vocab_size, (Bx, Tx), generator=torch.Generator().manual_seed(24))
        gcache = L.init_kv_cache(cfg_x, Bx, 64, device=dev)
        ccache = L.init_kv_cache(cfg_x, Bx, 64, device="cpu")
        torch.cuda.synchronize()
        reset_launch_counts()
        glog, gcache = L.prefill(gq_params, idsx.to(dev), cfg_x, gcache)
        gl = [glog[:, -1].float().cpu()]
        toks = [glog[:, -1].argmax(-1)]
        for s_ in range(stx):
            glog, gcache = L.decode_step(gq_params, toks[-1], cfg_x, gcache, Tx + s_)
            gl.append(glog.float().cpu())
            toks.append(glog.argmax(-1))
        torch.cuda.synchronize()
        counts = launch_counts()
        nl = cfg_x.num_layers
        assert counts["flash_attention_cached"] == nl * (stx + 1), f"{cname}: {counts}"
        clog, ccache = L.prefill(cq_params, idsx, cfg_x, ccache)
        cl = [clog[:, -1].float()]
        for s_ in range(stx):  # teacher-forced with the card's tokens
            clog, ccache = L.decode_step(cq_params, toks[s_].cpu(), cfg_x, ccache, Tx + s_)
            cl.append(clog.float())
        worst = 0.0
        for step, (g_, c_) in enumerate(zip(gl, cl)):
            assert torch.isfinite(g_).all() and torch.allclose(g_, c_, atol=0.1, rtol=0.05), f"{cname} step {step}"
            worst = max(worst, (g_ - c_).abs().max().item())
            top5 = c_.topk(5, dim=-1).indices
            assert (top5 == g_.argmax(-1, keepdim=True)).any(-1).all(), f"{cname}: greedy token outside top-5"
        hd_models.append({"config": cname, "head_dim": cfg_x.head_dim, "layers": nl, "hidden": cfg_x.hidden_size,
                          "batch": Bx, "prompt": Tx, "steps": stx, "max_abs_logit_diff": worst, "launches": counts})
        del gq_params, cq_params, gcache, ccache
        torch.cuda.empty_cache()
    # quantize_4bit(generator=): kernel 1's stochastic mode, within one rank of round-to-nearest
    Wq = torch.randn(4096, 4096, generator=gen, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    pk, sk = F4.quantize_4bit(Wq, blocksize=bs, generator=torch.Generator(device=dev).manual_seed(25))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["quantize_4bit_codes"] == 1 and sum(counts.values()) == 1, f"quantize_4bit(generator=): {counts}"
    pn, sn = F4.quantize_4bit(Wq, blocksize=bs)
    assert torch.equal(sk.absmax, sn.absmax)
    rank_of = torch.argsort(torch.argsort(torch.from_numpy(get_4bit_code("nf4", bs)), stable=True),
                            stable=True).to(dev)
    ranks = [rank_of[F4.unpack_4bit(t).long()] for t in (pk, pn)]
    moved = (ranks[0] != ranks[1]).float().mean().item()
    assert (ranks[0] - ranks[1]).abs().max().item() <= 1 and 0.1 < moved < 0.4, f"stochastic: moved {moved}"
    emit("repaired_entry_points", linear4bit=lin_cases, optimizers=opt_cases, head_dim_models=hd_models,
         quantize_4bit_generator={"shape": [4096, 4096], "moved_share": moved, "max_rank_step": 1})
    del Wq, pk, pn
    torch.cuda.empty_cache()

    # -- 6. kernels line and result ---------------------------------------
    kernels = [report[n] for n in TPU_KERNELS]
    for k in kernels:
        assert k["launches"] and k["launches"] > 0, k["name"]
    print(smi, flush=True)  # again, beside the numbers: the first lines scroll out of a short log
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
