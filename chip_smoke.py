#!/usr/bin/env python3
"""Chip check of bitsandbytes_tpu_torch on one NVIDIA GPU (written for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (every one asserts; any failure exits non-zero before the result):

1. Device: the card's name and power limit (nvidia-smi), TF32 off.
2. Build: compiles the CUDA kernels from ``bitsandbytes_tpu_torch/csrc``.
3. Kernels against their plain PyTorch versions on the card, at the main
   paths' shapes (Llama-3-8B geometry), with times, bytes and bounds; kernels
   2 and 5 also with the host held out of the window at M 8 and 16 and with
   f16 A, their split plans, each 16-bit call against a second run bit for
   bit (3b, 3f); kernels 3 and 6 at the four linears in bf16, f16 and f32,
   bit for bit against their plain versions, a second call and (6) kernel 3
   on the resolved absmax, device time with the host held out beside the
   store floor (``zero_()`` of the same W) (3b, 3f); the device-time sweep of
   kernels 2 and 5 against dequantize + matmul that chose
   ``functional/gemm.LARGE_M_THRESHOLD`` (3d); ragged shapes, kernels 2 and 5
   on the tensor cores at M 1-33, N not a multiple of 16 and blocksize
   32-4096, and mismatched plans refused by their C entries, kernels 3 and 6
   bit for bit at N/2 odd, tiles partial in N and K, blocksizes 8-4096 and
   Llama's down (3e);
   the backward kernels 7 and 8 (3h: ragged shapes up to M 33 and blocksize
   32-512, each 16-bit call against a second run bit for bit, kernel 8
   against kernel 7 on the resolved absmax bit for bit, times with the host
   held out of the window at M 1-33 and with f16 g, the split plan and an
   all-zero payload; mismatched plans refused by the C entry), the fused
   8-bit optimizer update, kernel 14 (3i: single tensors, and one grouped
   launch over the 448 adapter tensors of 4d and over ragged tables in f32,
   bf16 and f16 bit for bit, its device time against its bound, the SASS
   checked for local stores), and the sweep of kernels 7 and 8
   against dequantize (in g's type) + matmul, device time, with bf16, f16
   and f32 g up to M 2048, that chose ``functional/gemm.BACKWARD_LARGE_M_THRESHOLD``
   and its f16 and f32 counterparts (3j); kernel 4's int8-KV
   mode and kernel 16 (paged, bf16 and int8) at block sizes 16-256, each
   paged result against kernel 4 on the same data (3k); kernels 9, 10 and 11
   on the K-adjacent layout of bf16 ``quant_storage`` (3l: kernel 9 on the
   tensor cores at M 1-40 and blocksize 32-4096, its nested instance and
   kernel 10's ``_dq`` mode bit for bit against the plain ones on the
   resolved absmax, each 16-bit call against a second run and its f32
   output rounded, mismatched plans refused by the C entries; kernel 10,
   plain and ``_dq``, bit for bit against its plain versions and a second
   call in bf16, f16 and f32, also at the edges of its 16384-element tile
   (blocksizes 16, 48, 96 and 4096, odd counts), and timed at the four
   linears in each output type beside the store floor and kernel 3 on the
   same weights; kernels 9 and
   11 timed with the host held out, 9 at M 8 and 16 in bf16 and f16, 11 at M
   1-33 and with f16 g, its split plan printed; the device-time sweep of
   kernel 9 against kernel 10 + matmul in bf16, f16 and f32 that chose
   ``functional/gemm.KADJACENT_LARGE_M_THRESHOLD`` and
   ``KADJACENT_F32_LARGE_M_THRESHOLD``, and of kernel 11 against kernel 10 +
   matmul in bf16, f16 and f32 that, with 3j, chose the backward thresholds;
   kernel 11 with 2 and 4 splits bit for bit its plain version on inputs
   whose every f32 sum is exact); kernel 15, the 8-bit AdEMAMix
   update (3m, as 3i).  Kernel 1 (3a) bit for bit against its plain
   version and against itself on the f32 copy: nf4, fp4 and int4 at
   blocksizes 32, 64, 256 and 4096 and af4 at 64, W in f32, bf16 and f16,
   counts that end inside a tile, an all-zero block, both rounding modes
   (the stochastic one on the same uniforms); gate_up timed in f32 and bf16,
   each rounding mode, with and without the host in the window, and its
   SASS checked for local stores (``sass_stl``).  Kernel 13 (3f, 3g) bit for
   bit at blocksizes 32-4096 on the dynamic map (buckets), 256 linear
   entries, the unsigned dynamic map (the binary search) and fp4 (unsorted:
   the linear count), both modes, small inputs and full tiles; the nested
   absmax and the lm_head timed with and without the host in the window;
   kernels 2, 3, 5 and 6 on f16 and f32 activations and kernels 7 and 8 on
   f16 g (3e); kernels 14 and 15 on bf16 and f16 parameters (3i, 3m);
   kernels 4 and 16 at head_dim 64, 128 and 256, bf16 and int8, paged
   against dense bit for bit and each twice, bit for bit (3c, 3k), and the
   split combine that follows them at decode.  LLM.int8() (3n), which no
   TPU kernel carries: the smallest M the card's ``torch._int_mm`` takes
   unpadded, the row-wise quantize at thresholds 0 and 6 and the double
   quantize bit for bit against the CPU, the int32 product at M 1, 8, 16,
   17, 33 and 2048 on the Llama-3-8B linear shapes (padded as the port
   pads) bit for bit against the CPU, the epilogue within float32 rounding,
   and one int8 linear timed at M 8 and 2048 beside ``torch._int_mm`` alone
   and ``torch.matmul`` on the bf16 weight; then kernels 12 and 13's
   ``_any`` instances (blocksizes off the tiles: 12, 48, 100, 8192, ragged
   n, three codebooks, both rounding modes) bit for bit against their plain
   versions, timed at an lm_head-sized tensor beside the tiles.  The host
   quantizer (3o, ``utils/native``, C++ and OpenMP on the host) on the f32
   gate_up, nf4 and fp4: codes and absmax bit for bit kernel 1's, the host
   seconds beside kernel 1's device ms.  Kernels 17-19, the causal flash
   attention of the training path (3p: forward, dK/dV and dQ), each against
   its plain version and twice bit for bit at Llama-3-8B's attention (H 32
   over 8, hd 128) at T 1024-8192 and Gemma-7B's (H 16, hd 256) at T 4096,
   device ms beside SDPA forward and backward and each bound (each also
   beside its earlier mma.sync body's; their SASS must show wgmma and TMA
   and no local stores; the dK/dV kernel's combine bit for bit its plain
   version at T 1024; in f32 the three kernels' three-pass TF32 instances
   at hd 128 and 256 beside the wide family's; the 16-bit forward's streamed
   instance at hd 640, 768 and 1024 beside SDPA's forward and the wide
   forward; the wide family where the route sends it: f32 at hd 384 and 512,
   16-bit dK/dV and dQ from hd 640); then the kernels against the dense
   oracle at T 512 and 1024, below the route's line.
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
   kernels 9 and 10 in their nested modes, with no decode of the absmax
   before a call), double-quantized, trained with ``ademamix8bit`` (kernel
   15).  4g serves 4a's bf16 weights (kept from 4a's profiled load) through
   ``quantize_params_int8`` as 4a does: int8 linears on ``torch._int_mm``,
   kernel 4 and its combine the only kernels of the table.  4h carries
   checkpoints at full width: 4b's double-quantized model, still held,
   through ``save_checkpoint_safetensors`` into a temporary directory and
   back onto the card with ``load_checkpoint_safetensors(template=...)``,
   every leaf bit for bit, the reference's key names in the file, and one
   prefill and 4 decode steps on both with bit-identical logits on 4b's
   route; then 4a's bf16 weights under HF Transformers' names through
   ``import_hf_llama(quantize="nf4")`` (kernel 1 once a linear, every layer
   bit for bit ``quantize_params_4bit(fuse=False)``), served unfused for one
   prefill and 4 decode steps.  4i loads the committed trained fixture
   (``tests/fixtures/quality_lm.*``) with the port's loader and holds its
   perplexity on all 64 eval sequences in bf16, NF4, NF4 with the absmax
   double-quantized, FP4, LLM.int8() and LLM.int8() at threshold 6 to the
   bounds of ``tests/test_quality.py``.  4j trains 4d's adapters on 4d's
   model again with ``paged_adamw8bit`` (states in pinned host memory,
   paged in and out each step), then ``adamw32bit`` and
   ``paged_adamw32bit``: losses, adapters and states bit for bit the
   unpaged runs', every state pinned, kernel 14 once a step; the step time,
   the page-in and page-out copies under the profiler, the device memory
   between steps and at the peak.  4k runs the embeddings at Llama-3-8B
   widths: ``EmbeddingNF4`` [32000, 4096] (kernel 1 to build, kernel 10 over
   the 1024 gathered rows of an 8 x 128 lookup, timed against
   ``F.embedding`` on the bf16 table and kernel 10 over the whole table),
   ``Embedding8bit``, ``StableEmbedding`` with a ``Linear4bit`` gate trained
   3 steps under ``GlobalOptimManager`` (the table at 32 bits, the rest
   8-bit: kernel 14), and ``OutlierAwareLinear`` at the gate's shape against
   ``Linear8bitLt``.  4l runs the GPT-2/OPT family at OPT-125M's widths in
   bf16, NF4 (kernel 2 at M 8, kernel 3 + matmul at M 8 x 512) and int8.
   4n serves 4a's model over a mesh at one rank, a real NCCL group
   (``parallel.llama_param_specs``, ``shard_kv_cache``, ``forward(mesh=)``):
   prefill and 8 decode steps with the logits bit for bit, the tokens and
   launches those of the same run without a mesh and every collective
   counted, then the engine with ``mesh=`` (bf16 dense and paged pools)
   against the engine without, the same streams and launches; then every
   rank's shard of a 2- and 4-rank virtual mesh of layer 0's wo and down
   and of the quantized lm_head through kernel 2 (M 8, within 1e-3
   relative of its slice of the full output) and kernel 3 (bit for bit its
   slice), and a double-quantized wo's through kernels 5 and 6.  4m runs one
   MoE layer at Mixtral-8x7B's widths (8 experts of hidden 4096, ffn 14336,
   top 2, NF4): kernel 1 16 times to build it, kernel 2 at M 8 and kernel 3
   + matmul at M 1024, device ms beside the same experts in bf16 through
   ``torch.matmul`` (and held within atol 0.1 / rtol 0.05 of them), the
   gates bit for bit the CPU's, expert parallelism at one rank bit for bit
   the dense layer.  4o runs ring attention at Llama-3-8B widths (B 1, T
   4096, H 32 over 8 KV heads, hd 128, bf16) at one NCCL rank, forward and
   backward, against the dense f32 oracle, SDPA and the flash kernels 17-19
   (errors, ms, peak memory), and rings of 2 and 4 rank by rank in one process against one;
   then GPipe over 32 NF4 [4096, 4096] layers, x [64, 4096] in 4
   microbatches (kernel 2 forward, kernel 7 for grad_x), bit for bit the
   layers run microbatch by microbatch, beside one sequential pass.  4p
   runs 4d's QLoRA step over a ``{"data": 1, "seq": 1, "model": 1}`` mesh
   (ring attention, the split linears' adjoints, the loss and gradient
   sums), 3 steps against a meshless step: loss, gradients, the launches of
   kernels 6 and 14, the collectives a step, wall and device ms, memory.
   4q runs Mistral-7B (``LlamaConfig.mistral_7b()``: 4b's weights, rope
   theta 1e4, sliding window 4096): batch 2 of 4608-token prompts and 16
   greedy steps over a bf16 cache of 4672 positions, meshless and over a
   ``{"data": 1, "seq": 1, "model": 1}`` mesh at one NCCL rank, logits bit
   for bit, and a 2-layer copy at virtual ``seq`` coordinates 0 and 1 bit
   for bit; the windowed ring at T 8192 (one rank, rings of 2 and 4 rank by
   rank) forward and backward against the windowed dense oracle, timed
   beside it and SDPA with a boolean mask; one QLoRA step of a 2-layer copy
   at T 6144 over the mesh against the meshless step.  4r trains 4b's
   model through kernels 17-19 (the no-cache route of ``_flash_ok``): all
   32 layers at T 2048 (rank 64, seven targets, ``adamw8bit``, five steps;
   32 launches of each a step, device ms by class, peak memory), 4 layers
   at T 2048 against the same step on the dense oracle (the loss within
   rel 1e-3), and 4 layers at T 8192; 32 layers in f16, and 4 layers in
   f32 (the TF32 forward, dK/dV and dQ) against the f32 oracle
   (rel 1e-4).
   The kernels' launch counts are zeroed just before each path and read
   just after it.  4a and 4b also
   load the model once more under
   ``torch.profiler`` (device time by class: kernel 1, kernel 13, copies and
   casts, the rest) and check that layer 0's payloads and states equal those
   of the loader's former route, each weight cast to f32 first.  Each
   serving path also profiles one more prefill
   (device time, launches, the dequantize's share), and each training path
   one step by kernel class.
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
   ``compute_dtype`` (and on bf16 ``quant_storage`` in bf16, f16 and f32, on
   both sides of each threshold), ``adamw8bit`` and ``ademamix8bit`` over bf16
   parameters, ``prefill``/``decode_step`` at head_dim 64 (``tiny``) and 256
   (``gemma_7b`` at 2 layers), and ``quantize_4bit(generator=)``; then
   LLM.int8() at 2 layers (5f): CB and SCB bit for bit, prefill and decode
   steps, the forward at ``int8_threshold=6`` with a planted outlier
   feature, one ``Linear8bitLt(has_fp16_weights=True, threshold=6)`` step at
   M 2048 with its gradients, and the engine over int8 weights (4 requests,
   teacher-forced top-5), each against the CPU; then checkpoint interop at 2
   layers and a quarter of the widths (5g): NF4 (fused), nested, int8 and
   bf16 ``quant_storage`` trees
   written on the card and read on the CPU and the reverse, npz and
   safetensors, bit for bit (the two safetensors files byte for byte),
   ``import_hf_llama`` in nf4, fp4 and int8 mode and ``dequantize_tree``
   (kernel 10) on the card against the CPU; then this slice's paths at 2
   layers and a quarter of the widths (5h): ``GPT2Config.tiny()`` in NF4
   and int8, the embeddings and ``OutlierAwareLinear``, and 3 steps of each
   paged optimizer, paged against unpaged bit for bit, card against CPU;
   and ``python -m bitsandbytes_tpu_torch`` as a subprocess, exit code 0;
   then the MoE at hidden 256 and the sharded forward of a 2-layer Llama at
   a quarter of the widths over the one-rank mesh, card against CPU (5i);
   then ring attention (rings of 2 and 4 rank by rank, and at one NCCL
   rank with its gradients), GPipe over 4 NF4 layers and one meshed QLoRA
   step of the tiny Llama, card against CPU (5j); then the backward with f16
   and f32 g on both sides of each threshold, the windowed ring and the
   tiny Llama with a sliding window served and trained over the one-rank
   mesh, card against CPU (5k); then a 2-layer bf16 Llama (hidden 512, hd
   128) at T 1024 through kernels 17-19 against the CPU port on their
   plain versions: the loss and the adapter gradients (5l; the dK/dV
   kernel's combine runs here, where its plan splits key tiles), and the
   same in f16 and f32, at hd 512 in bf16 (the sliced instances) and f32
   (the wide family's dK/dV, which no preset's f32 step takes now), and at
   hd 640 in bf16 (the forward's streamed instance).
6. The card's name and power limit once more, one JSON line describing
   every ported kernel, then the result line.

Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import ctypes
import importlib
import math
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): the least time the
# card could take for a kernel's work is bounded by these.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # a three-pass TF32 product does 3x its flops at this rate

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
    # kernel 9 and 10 with the double-quantized absmax decoded in the kernel:
    # the TPU kernels take the absmax decoded beforehand
    "gemm_4bit_fused_dq": (
        "bitsandbytes_tpu/ops/pallas/gemm4bit.py:265", "bitsandbytes_tpu_torch/csrc/gemm4bit.cu"),
    "dequantize_4bit_2d": ("bitsandbytes_tpu/ops/pallas/gemm4bit.py:330", "bitsandbytes_tpu_torch/csrc/gemm4bit.cu"),
    "dequantize_4bit_2d_dq": (
        "bitsandbytes_tpu/ops/pallas/gemm4bit.py:330", "bitsandbytes_tpu_torch/csrc/gemm4bit.cu"),
    "gemm_4bit_nt_fused": ("bitsandbytes_tpu/ops/pallas/gemm4bit.py:444", "bitsandbytes_tpu_torch/csrc/gemm4bit.cu"),
    "optimizer_update_8bit_ademamix": (
        "bitsandbytes_tpu/ops/pallas/optim8bit.py:323", "bitsandbytes_tpu_torch/csrc/optim8bit.cu"),
    # the split-KV combine of kernels 4 and 16: the TPU kernel carries m, l and
    # acc across its ordered S grid axis instead
    "flash_attention_combine": (
        "bitsandbytes_tpu/ops/pallas/flash_cached.py:482",
        "bitsandbytes_tpu_torch/csrc/flash_cached.cu"),
    # the upstream Pallas flash attention the JAX package's no-cache forward
    # reaches through bitsandbytes_tpu/models/llama.py:_flash_call (:450)
    "flash_attention_causal_fwd": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    "flash_attention_causal_bwd_dkv": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    # the combine of the key tiles kernel 18's work plan splits: the TPU
    # kernel carries dK and dV across its ordered grid axes instead
    "flash_attention_causal_bwd_dkv_combine": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    "flash_attention_causal_bwd_dq": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    # kernels 17-19 in f16: the same wgmma kernels, instantiated for f16
    # (3p's f16 shapes, launched by 4r(d)'s f16 steps)
    "flash_attention_causal_fwd_f16": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    "flash_attention_causal_bwd_dkv_f16": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    "flash_attention_causal_bwd_dq_f16": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    # kernel 17's column-sliced wgmma instances: bf16 and f16 at head_dim 384
    # and 512 (launched by 5l's head_dim 512 step)
    "flash_attention_causal_fwd_sliced": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    # kernel 18's wgmma instances at head_dim 384 and 512 (bf16, f16): a stage
    # holds q and do in the item's 128 columns, the rest of head_dim streams
    # through a ring of 64-column chunks (launched by 5l's head_dim 512 step)
    "flash_attention_causal_bwd_dkv_sliced": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    # kernel 19's wgmma instances at head_dim 384 and 512 (bf16, f16): a block
    # owns half of dq's columns, a stage holds the K tile's slice, and K's
    # other chunks and V's stream through a ring of 64-column chunks
    # (launched by 5l's head_dim 512 step)
    "flash_attention_causal_bwd_dq_sliced": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    # kernel 17's streamed wgmma instance: bf16 and f16 at every head_dim
    # from 640, head_dim streamed in 64-column chunks (launched by 5l's
    # head_dim 640 step)
    "flash_attention_causal_fwd_streamed": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    # kernels 17-19's wide family: f32 from head_dim 384, and bf16 and f16
    # dK/dV and dQ from 640 (CUDA cores; launched by 5l's f32 step at
    # head_dim 512)
    "flash_attention_causal_fwd_wide": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    "flash_attention_causal_bwd_dkv_wide": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    "flash_attention_causal_bwd_dq_wide": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    # kernel 18's f32 instance at head_dim 128 and 256: every product as three
    # TF32 passes on wgmma (launched by 4r(e)'s f32 steps)
    "flash_attention_causal_bwd_dkv_tf32": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    # kernel 19's f32 instance at head_dim 128 and 256: S, dP and dQ^T = K^T
    # dS^T as three TF32 passes each on wgmma (launched by 4r(e)'s f32 steps)
    "flash_attention_causal_bwd_dq_tf32": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
    # kernel 17's f32 instance at head_dim 128 and 256: S = Q K^T and O^T =
    # V^T P^T as three TF32 passes each on wgmma (launched by 4r(e)'s f32
    # steps)
    "flash_attention_causal_fwd_tf32": (
        "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "bitsandbytes_tpu_torch/csrc/flash_attention.cu"),
}

# 3p's gates against the plain versions on the card, by q/k/v's type: (the
# output's abs error, each gradient's error relative to its largest
# magnitude); m within 1e-4 abs and l within 1e-5 relative in every type.
# f32 is tight enough to fail a single TF32 pass.
FLASH_TOLERANCES = {"bfloat16": (2e-2, 1e-2), "float16": (8e-3, 5e-3), "float32": (1e-5, 1e-4)}


FLASH_TRAIN = ("flash_attention_causal_fwd", "flash_attention_causal_bwd_dkv", "flash_attention_causal_bwd_dq")
# the wide family's launch counts (f32 from head_dim 384; bf16/f16 dK/dV and dQ from 640)
FLASH_TRAIN_WIDE = tuple(n + "_wide" for n in FLASH_TRAIN)
# the TF32 instances' launch counts (f32 at head_dim 128 and 256)
FLASH_TF32 = tuple(n + "_tf32" for n in FLASH_TRAIN)
FLASH_KERNELS = ("fwd", "dkv", "dq")


def flash_names(dtype, hd=128):
    """The launch counts of kernels 17, 18 and 19 that q/k/v of ``dtype`` at
    ``hd`` take, each kernel's family chosen on its own: a wgmma kernel's
    (``_sliced``: its instances at 384 and 512; ``_streamed``: the
    forward's from 640), a TF32 instance's or the wide family's."""
    from bitsandbytes_tpu_torch.ops import flash_attention as FA

    return tuple(FA.launch_name(k, dtype, hd) for k in FLASH_KERNELS)


# device time by class of a training step through the flash kernels (the
# sliced instances before their kernels' others: the first match names a
# kernel)
FLASH_CLASSES = [("flash_streamed_fwd_kernel", "kernel 17, streamed (hd 640 and up)"),
                 ("flash_fwd_kernel<384", "kernel 17, column-sliced (hd 384)"),
                 ("flash_fwd_kernel<512", "kernel 17, column-sliced (hd 512)"),
                 ("flash_bwd_dkv_kernel<384", "kernel 18, streamed chunks (hd 384)"),
                 ("flash_bwd_dkv_kernel<512", "kernel 18, streamed chunks (hd 512)"),
                 ("flash_bwd_dq_kernel<384", "kernel 19, column-sliced (hd 384)"),
                 ("flash_bwd_dq_kernel<512", "kernel 19, column-sliced (hd 512)"),
                 ("flash_fwd_kernel", "kernel 17 (flash forward)"), ("flash_bwd_dkv_kernel", "kernel 18 (flash dK/dV)"),
                 ("flash_bwd_dkv_combine", "kernel 18's combine"), ("flash_bwd_dq_kernel", "kernel 19 (flash dQ)"),
                 ("flash_tf32_fwd_kernel", "kernel 17, three-pass TF32 (f32)"),
                 ("flash_tf32_dkv_kernel", "kernel 18, three-pass TF32 (f32)"),
                 ("flash_tf32_dq_kernel", "kernel 19, three-pass TF32 (f32)"),
                 ("flash_wide_fwd_kernel", "kernel 17, wide family"),
                 ("flash_wide_dkv_kernel", "kernel 18, wide family"),
                 ("flash_wide_dq_kernel", "kernel 19, wide family"), ("dequantize_paired", "kernel 6"),
                 ("optimizer_update_8bit", "kernel 14")]

# the (HGMMA, UTMALDG) counts of the bf16 instances of kernels 17-19 by
# head_dim, from cuobjdump -sass of the build before they were templated on
# the element type (PERF.md §6): the f16 instances must leave them as they
# were
FLASH_BF16_SASS = {"flash_fwd_kernel": {128: (16, 6), 256: (40, 12)},
                   "flash_bwd_dkv_kernel": {128: (24, 8), 256: (40, 16)},
                   "flash_bwd_dq_kernel": {128: (20, 8), 256: (36, 16)}}

# kernel 17's device ms at 3p's shapes, (T, hd): -> ms, in its earlier mma.sync
# body (64-row blocks, a cp.async ring), measured by this script's 3p on an
# NVIDIA H100 80GB HBM3 at 700 W; 3p emits that body's bound share beside the
# kernel's
FLASH_FWD_MMA_SYNC_MS = {(1024, 128): 0.08396799862384796, (2048, 128): 0.2884800136089325,
                         (4096, 128): 1.06985604763031, (8192, 128): 4.154047966003418,
                         (4096, 256): 1.296288013458252}

# kernel 18's device ms at 3p's shapes, (T, hd): -> ms, in its earlier mma.sync
# body (a block 64 keys over the whole GQA group, a cp.async ring): the mean of
# that body's two medians in one run of experiments/ab_flash_attention_torch.py
# (parent, change, change, parent) on an NVIDIA H100 80GB HBM3 at 700 W; 3p
# emits that body's bound share beside the kernel's
FLASH_DKV_MMA_SYNC_MS = {(1024, 128): 0.3872480094432831, (2048, 128): 0.8520640134811401,
                         (4096, 128): 1.8784159421920776, (8192, 128): 7.299696207046509,
                         (4096, 256): 2.6357120275497437}

# kernel 19's device ms at 3p's shapes, (T, hd): -> ms, in its earlier mma.sync
# body (a block 64 query rows, four warps of 16, a cp.async ring): the mean of
# that body's two medians in one run of experiments/ab_flash_attention_torch.py
# (parent, change, change, parent) on an NVIDIA H100 80GB HBM3 at 700 W; 3p
# emits that body's bound share beside the kernel's
FLASH_DQ_MMA_SYNC_MS = {(1024, 128): 0.08718400076031685, (2048, 128): 0.2913280129432678,
                        (4096, 128): 1.0802720189094543, (8192, 128): 4.21343994140625,
                        (4096, 256): 1.2831679582595825}

LORA_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")

# Llama-3-8B decode linears (N, K) after fusing q/k/v and gate/up
LINEARS = {"wqkv": (6144, 4096), "wo": (4096, 4096), "gate_up": (28672, 4096), "down": (4096, 14336)}

# (g's type, M) of the backward route sweeps (3j, 3l): bf16 at the M that
# chose BACKWARD_LARGE_M_THRESHOLD, f16 and f32 from one row to QLoRA's 2048
# (f32 every 8 rows where its CUDA-core kernels change sides)
BACKWARD_SWEEP = [("bfloat16", m) for m in (1, 8, 16, 32, 48, 64, 65, 96, 128, 192, 256)] + [
    ("float16", m) for m in (1, 8, 16, 64, 65, 96, 128, 256, 2048)] + [
    ("float32", m) for m in (1, 8, 16, 24, 32, 40, 48, 64, 65, 128, 256, 2048)]


def backward_reps(dtype, M: int) -> dict:
    """``cuda_time``'s arguments for one point of a backward sweep: device
    time (L2 flushed, the host held out), fewer calls where the f32 g of
    M >= 256 runs the CUDA-core bodies for tens of ms a call."""
    import torch

    few = dtype == torch.float32 and M >= 256
    return {"n": 3 if few else 10, "warmup": 1 if few else 3, "flush_l2": True, "hold": True}


_T0 = time.perf_counter()


def emit(tag: str, **fields) -> None:
    """One JSON line for a phase, with the seconds since the script began."""
    print(json.dumps({"phase": tag, **fields, "t_s": round(time.perf_counter() - _T0, 1)}), flush=True)


_SASS = {}


def sass_of(so: str):
    """``cuobjdump -sass`` of the built library, once a run (None without
    the tool)."""
    if so not in _SASS:
        from bitsandbytes_tpu_torch.ops import _lib

        tool = os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump")
        _SASS[so] = (subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True,
                                    timeout=300).stdout if os.path.exists(tool) else None)
    return _SASS[so]


def registers_of(so: str, kernels) -> dict:
    """Registers a thread of each instance of ``kernels`` in the built
    library (``cuobjdump -res-usage``), by mangled name; empty without the
    tool."""
    from bitsandbytes_tpu_torch.ops import _lib

    tool = os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-res-usage", so], capture_output=True, text=True, check=True, timeout=300).stdout
    out, fn = {}, None
    for line in text.splitlines():
        if "Function " in line:
            fn = line.split("Function ", 1)[1].strip().rstrip(":")
            fn = fn if any(k in fn for k in kernels) else None
        elif fn and "REG:" in line:
            out[fn] = int(line.split("REG:", 1)[1].split()[0])
            fn = None
    return out


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def self_dev_us(e):  # named self_cuda_time_total before torch 2.4
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_events(prof):
    """Device-side events only (kernels, memcpy, memset): an operator's
    own entry repeats the time of the kernels it launched, and a user
    annotation (``Optimizer.step``) spans them on the device's timeline."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and self_dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]


def by_class(events, named):
    """Device ms and launches by kernel class: the (substring, label) pairs
    of ``named`` first, then cuBLAS GEMMs, copies and casts, the rest."""
    out = {}
    for e in events:
        label = next((lab for sub, lab in named if sub in e.key), None)
        if label is None:
            low = e.key.lower()
            if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
                label = "GEMM (cuBLAS)"
            elif "copy" in low or "cast" in low:
                label = "copies and casts"
            else:
                label = "other PyTorch kernels"
        c = out.setdefault(label, {"ms": 0.0, "launches": 0})
        c["ms"] += self_dev_us(e) / 1e3
        c["launches"] += e.count
    return out


def live_bytes():
    """The bytes that live tensors on the current card asked for, after a
    garbage collection: ``memory_allocated`` counts whole allocator blocks,
    and a block the allocator did not split holds up to 1 MiB beyond the
    request, so it moves with what the allocator has cached."""
    import gc

    import torch

    gc.collect()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def bits_equal(a, b):
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def tree_to(tree, device):
    """A parameter tree (tensors, QuantizedTensor, Int8TensorState) copied to
    ``device``."""
    import dataclasses

    from bitsandbytes_tpu_torch.nn.modules import Int8TensorState, QuantizedTensor
    from bitsandbytes_tpu_torch.nn.parametrize import map_tree

    def state_to(st):
        if st is None:
            return None
        return dataclasses.replace(st, absmax=st.absmax.to(device), code=st.code.to(device),
                                   offset=None if st.offset is None else st.offset.to(device),
                                   state2=state_to(st.state2))

    def leaf(_, x):
        if isinstance(x, QuantizedTensor):
            return QuantizedTensor(data=x.data.to(device), state=state_to(x.state))
        if isinstance(x, Int8TensorState):
            return Int8TensorState(CB=x.CB.to(device), SCB=x.SCB.to(device))
        return x.to(device)

    return map_tree(leaf, tree)


def tree_mismatches(a, b, path=""):
    """``(leaves compared, paths that differ)`` between two parameter trees,
    on any devices: payloads, absmax (f32 or uint8 codes), code maps,
    offsets, second-level states and float leaves bit for bit, with their
    static fields."""
    from bitsandbytes_tpu_torch.nn.modules import Int8TensorState, QuantizedTensor

    def same(x, y):
        return bits_equal(x.cpu(), y.cpu())

    def state_same(s, t):
        if (s is None) != (t is None):
            return False
        if s is None:
            return True
        static = ("blocksize", "quant_type", "dtype", "shape", "layout", "dynamic_code")
        return (all(getattr(s, f) == getattr(t, f) for f in static) and same(s.absmax, t.absmax)
                and same(s.code, t.code) and ((s.offset is None) == (t.offset is None))
                and (s.offset is None or same(s.offset, t.offset)) and state_same(s.state2, t.state2))

    if isinstance(a, dict):
        if set(a) != set(b):
            return 0, [path]
        pairs = [(a[k], b[k], f"{path}.{k}" if path else str(k)) for k in a]
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return 0, [path]
        pairs = [(x, y, f"{path}.{i}") for i, (x, y) in enumerate(zip(a, b))]
    elif isinstance(a, QuantizedTensor):
        ok = isinstance(b, QuantizedTensor) and same(a.data, b.data) and state_same(a.state, b.state)
        return 1, [] if ok else [path]
    elif isinstance(a, Int8TensorState):
        ok = isinstance(b, Int8TensorState) and same(a.CB, b.CB) and same(a.SCB, b.SCB)
        return 1, [] if ok else [path]
    else:
        return 1, [] if same(a, b) else [path]
    n, bad = 0, []
    for x, y, p in pairs:
        m, d = tree_mismatches(x, y, p)
        n, bad = n + m, bad + d
    return n, bad


def tree_bytes(tree) -> int:
    """Bytes of every tensor a parameter tree holds, quantization states
    included."""
    from bitsandbytes_tpu_torch.nn.modules import Int8TensorState, QuantizedTensor

    def state_bytes(st):
        if st is None:
            return 0
        ts = [st.absmax, st.code] + ([st.offset] if st.offset is not None else [])
        return sum(t.numel() * t.element_size() for t in ts) + state_bytes(st.state2)

    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, QuantizedTensor):
        return tree.data.numel() * tree.data.element_size() + state_bytes(tree.state)
    if isinstance(tree, Int8TensorState):
        return sum(t.numel() * t.element_size() for t in (tree.CB, tree.SCB))
    return tree.numel() * tree.element_size()


def serve_short(params, ids, cfg, max_len, steps):
    """One prefill of ``ids`` and ``steps`` greedy decode steps over a new
    bf16 cache: the logits of every call and the tokens ``[B, steps + 1]``."""
    import torch

    from bitsandbytes_tpu_torch.models import llama as L

    cache = L.init_kv_cache(cfg, ids.shape[0], max_len, device=ids.device)
    logits, cache = L.prefill(params, ids, cfg, cache)
    outs, tok = [logits], logits[:, -1].argmax(-1)
    toks = [tok]
    for s in range(steps):
        logits, cache = L.decode_step(params, tok, cfg, cache, ids.shape[1] + s)
        tok = logits.argmax(-1)
        outs.append(logits)
        toks.append(tok)
    torch.cuda.synchronize()
    return outs, torch.stack(toks, 1)


def profiled(fn):
    """``fn()`` under ``torch.profiler``: its result and its device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, device_events(prof), wall_ms


LOAD_CLASSES = [("Memcpy HtoD", "host-to-device copies"), ("quantize_4bit_codes", "kernel 1 (quantize_4bit_codes)")]


def checkpoint_round_trip(cfg, held, ids, max_len, expected):
    """4h(a): write the held double-quantized model with
    ``save_checkpoint_safetensors``, read it back onto the card with the
    model as the template, hold every leaf bit for bit, and serve both: the
    logits of one prefill and 4 decode steps bit-identical, the launch
    counts ``expected`` (the nested route) on each."""
    import shutil
    import tempfile

    import torch

    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.utils import serialization as S

    dev = ids.device
    need = tree_bytes(held) + (256 << 20)  # the file holds the same bytes, plus its header
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise RuntimeError(f"the checkpoint needs {need} bytes of disk, {tmp} has {free}")
        path = os.path.join(tmp, "llama3_8b_nf4_nested.safetensors")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = S.save_checkpoint_safetensors(path, held, metadata={"format": "pt"})
        save_s = time.perf_counter() - t0
        assert nbytes == os.path.getsize(path), "the writer's size is the file's"

        # the reference's names for a nested NF4 weight, read from the header
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            base = "layers.0.wqkv"
            meta_info = header[f"{base}.quant_state.bitsandbytes__nf4"]
            f.seek(8 + n + meta_info["data_offsets"][0])
            meta = json.loads(f.read(meta_info["data_offsets"][1] - meta_info["data_offsets"][0]))
        N, K = held["layers"][0]["wqkv"].state.shape
        want = {base: ("U8", [N * K // 2, 1]), f"{base}.absmax": ("U8", [N * K // 64]),
                f"{base}.quant_map": ("F32", [16]), f"{base}.nested_absmax": ("F32", [-(-N * K // 64 // 256)]),
                f"{base}.nested_quant_map": ("F32", [256]), "embed": ("BF16", [cfg.vocab_size, cfg.hidden_size])}
        for k, (dt, shape) in want.items():
            assert header[k]["dtype"] == dt and header[k]["shape"] == shape, f"{k}: {header[k]}"
        assert meta == {"quant_type": "nf4", "blocksize": 64, "dtype": "float32", "shape": [N, K],
                        "nested_blocksize": 256, "nested_dtype": "float32",
                        "nested_offset": meta["nested_offset"]}, meta
        assert header["__metadata__"] == {"format": "pt"} and n % 8 == 0

        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = S.load_checkpoint_safetensors(path, template=held, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        assert not any(launch_counts().values()), "the load launches no kernel of the table"
        again, events, prof_wall_ms = profiled(lambda: S.load_checkpoint_safetensors(path, held, device=dev))
        del again
        torch.cuda.empty_cache()
        n_leaves, bad = tree_mismatches(loaded, held)
        assert not bad, f"reloaded leaves differ: {bad[:8]}"
        assert all(loaded["layers"][i][k].state.inline_nested for i in range(cfg.num_layers)
                   for k in ("wqkv", "wo", "gate_up", "down")), "the reloaded states decode in the kernels"

        runs = {}
        for tag, tree in (("reloaded", loaded), ("held", held)):
            reset_launch_counts()
            outs, toks = serve_short(tree, ids, cfg, max_len, 4)
            counts = launch_counts()
            want_counts = {k: 0 for k in counts}
            want_counts.update(expected)
            assert counts == want_counts, f"{tag}: launch counts {counts} != {want_counts}"
            runs[tag] = (outs, toks, counts)
        assert all(bits_equal(a, b) for a, b in zip(runs["reloaded"][0], runs["held"][0])), \
            "the reloaded model's logits differ from the held model's"
        dev_us = sum(self_dev_us(e) for e in events)
        emit("checkpoint_round_trip", config="llama3_8b", layers=cfg.num_layers, weights="nf4, nested, fused",
             file_bytes=nbytes, model_bytes=tree_bytes(held), save_s=save_s, load_s=load_s,
             profiled_load={"wall_ms": prof_wall_ms, "device_ms": dev_us / 1e3,
                            "device_launches": sum(e.count for e in events), "by_class": by_class(events, LOAD_CLASSES)},
             leaves_bit_identical=n_leaves, logits_bit_identical=True, serve_steps=4,
             launches=runs["reloaded"][2], first_tokens=runs["reloaded"][1][0].tolist(), disk_free=free)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


_HF_NAMES = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj",
             "attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm"}


def hf_state_dict(params) -> dict:
    """``models/llama.py``'s bf16 tree under HF Transformers' Llama names
    (``model.layers.{i}.self_attn.q_proj.weight``, ...): the same tensors,
    no copy."""
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"],
          "lm_head.weight": params["lm_head"]}
    for i, layer in enumerate(params["layers"]):
        for ours, hf in _HF_NAMES.items():
            sd[f"model.layers.{i}.{hf}.weight"] = layer[ours]
    return sd


def hf_import(cfg, ids, max_len, tokens_4a, expected):
    """4h(b): the seed-0 bf16 tree of 4a under HF names through
    ``import_hf_llama(quantize="nf4")`` on the card: kernel 1 once a linear,
    every layer bit for bit ``quantize_params_4bit(fuse=False)`` of the same
    weights; then one prefill and 4 decode steps on the unfused tree with
    the launch counts ``expected``."""
    import torch

    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.utils import serialization as S

    dev = ids.device
    Lyr = cfg.num_layers
    params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    sd = hf_state_dict(params)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imported = S.import_hf_llama(sd, cfg, quantize="nf4", device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want["quantize_4bit_codes"] = 7 * Lyr
    assert counts == want, f"hf import: launch counts {counts} != {want}"
    again, events, prof_wall_ms = profiled(lambda: S.import_hf_llama(sd, cfg, quantize="nf4", device=dev))
    del again
    for i in range(Lyr):
        ref = L.quantize_params_4bit({"layers": [params["layers"][i]]})["layers"][0]
        n_leaves, bad = tree_mismatches(imported["layers"][i], ref)
        assert not bad and n_leaves == 9, f"layer {i}: {bad} differ from quantize_params_4bit"
        assert imported["layers"][i]["wq"].state.layout == "paired"
    assert all(imported[k].data_ptr() == params[k].data_ptr() for k in ("embed", "lm_head", "final_norm")), \
        "tensors already on the card in the right type are not copied"
    quantized_bytes = sum(tree_bytes(layer) for layer in imported["layers"])
    resident = tree_bytes(imported)
    del params, sd, ref
    torch.cuda.empty_cache()

    reset_launch_counts()
    t0 = time.perf_counter()
    outs, toks = serve_short(imported, ids, cfg, max_len, 4)
    serve_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want.update(expected)
    assert counts == want, f"hf import serve: launch counts {counts} != {want}"
    assert all(torch.isfinite(o).all() for o in outs)
    dev_us = sum(self_dev_us(e) for e in events)
    emit("hf_import", config="llama3_8b", layers=Lyr, quantize="nf4", layout="paired, unfused", load_s=load_s,
         resident_bytes=resident, quantized_layer_bytes=quantized_bytes,
         profiled_load={"wall_ms": prof_wall_ms, "device_ms": dev_us / 1e3,
                        "device_launches": sum(e.count for e in events), "by_class": by_class(events, LOAD_CLASSES)},
         equals_quantize_params_4bit=True, serve_steps=4, serve_wall_ms=serve_ms, launches=counts,
         first_tokens=toks[0].tolist(), first_tokens_equal_4a=bool(torch.equal(toks, tokens_4a[:, : toks.shape[1]])),
         rows_equal_4a=int((toks == tokens_4a[:, : toks.shape[1]]).all(1).sum()))
    del imported, outs
    torch.cuda.empty_cache()


def perplexity_gate(root, dev):
    """4i: the committed trained fixture (``tests/fixtures/quality_lm.*``)
    loaded onto the card with the port's loader; its perplexity on all 64
    eval sequences in bf16, NF4, NF4 with a double-quantized absmax, FP4,
    LLM.int8() and LLM.int8() at outlier threshold 6, held to the bounds of
    ``tests/test_quality.py``."""
    import numpy as np
    import torch

    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.utils import serialization as S

    fix = os.path.join(root, "tests", "fixtures")
    with open(os.path.join(fix, "quality_lm.json")) as f:
        meta = json.load(f)
    cfg = L.LlamaConfig(**meta["config"], dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = S.load_checkpoint_safetensors(os.path.join(fix, "quality_lm.safetensors"),
                                           L.init_params(cfg, device=dev), device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ids = torch.from_numpy(np.load(os.path.join(fix, "quality_eval_ids.npy")).astype(np.int64)).to(dev)
    assert ids.shape == (64, 257)
    n_lin = 7 * cfg.num_layers
    formats = {  # name: (quantize, int8 threshold, launches)
        "bf16": (lambda p: p, 0.0, {}),
        "nf4": (lambda p: L.quantize_params_4bit(p, quant_type="nf4"), 0.0,
                {"quantize_4bit_codes": n_lin, "dequantize_paired_fast": n_lin}),
        "nf4_dq": (lambda p: L.quantize_params_4bit(p, quant_type="nf4", compress_statistics=True), 0.0,
                   {"quantize_4bit_codes": n_lin, "quantize_blockwise8": n_lin, "dequantize_paired_fast_dq": n_lin}),
        "fp4": (lambda p: L.quantize_params_4bit(p, quant_type="fp4"), 0.0,
                {"quantize_4bit_codes": n_lin, "dequantize_paired_fast": n_lin}),
        "int8": (L.quantize_params_int8, 0.0, {}),
        "int8_thr6": (L.quantize_params_int8, 6.0, {}),
    }
    ppl, launches, ms = {}, {}, {}
    for name, (quantize, thr, expected) in formats.items():
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss = L.lm_loss(quantize(params), None, ids, cfg, int8_threshold=thr)
        ppl[name] = math.exp(loss.item())
        ms[name] = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        want = {k: 0 for k in counts}
        want.update(expected)
        assert counts == want, f"perplexity {name}: launch counts {counts} != {want}"
        launches[name] = {k: v for k, v in counts.items() if v}
    ref = meta["eval_ppl_bf16_n64"]
    ratios = {k: v / ppl["bf16"] for k, v in ppl.items()}
    emit("perplexity_gate", fixture="tests/fixtures/quality_lm.safetensors", n_params=meta["n_params"],
         sequences=64, tokens_per_sequence=256, load_s=load_s, ppl=ppl, ratio_to_bf16=ratios,
         bf16_vs_recorded=abs(ppl["bf16"] - ref) / ref, recorded_eval_ppl_bf16_n64=ref,
         dq_vs_nf4=abs(ppl["nf4_dq"] - ppl["nf4"]) / ppl["nf4"],
         thr_vs_int8=abs(ppl["int8_thr6"] - ppl["int8"]) / ppl["int8"], ms=ms, launches=launches)
    # tests/test_quality.py's bounds, as they stand
    assert abs(ppl["bf16"] - ref) / ref < 0.02, (ppl["bf16"], ref)
    assert ratios["int8"] < 1.005 and ratios["int8_thr6"] < 1.005, ratios
    assert abs(ppl["int8_thr6"] - ppl["int8"]) / ppl["int8"] < 0.003, ppl
    assert ratios["nf4"] < 1.04, ratios
    assert ratios["fp4"] < 1.05, ratios
    assert abs(ppl["nf4_dq"] - ppl["nf4"]) / ppl["nf4"] < 0.003, ppl
    del params
    torch.cuda.empty_cache()


def interop_cpu_check(cfg, quantize_2d, dev):
    """5g: checkpoints of 2-layer trees at ``cfg`` (a quarter of Llama-3-8B's
    widths: at the full widths the CPU's plain quantize and the file traffic
    made this the longest phase of the run) written on the card and read on
    the CPU, and the reverse, in both file formats, for NF4 (fused), nested,
    int8 and bf16 quant_storage ("2d", uint16 payload), every leaf bit for bit
    and the two safetensors files byte for byte; ``import_hf_llama`` in nf4,
    fp4 and int8 mode and ``dequantize_tree`` on the card against the CPU. 4h
    carries the full widths through a file on the card."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.nn.parametrize import dequantize_tree
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.utils import serialization as S

    cpu_float = L.init_params(cfg, torch.Generator().manual_seed(9), device="cpu")
    gfloat = tree_to(cpu_float, dev)
    variants = {
        "nf4_fused": lambda t: L.quantize_params_4bit(t, fuse=True),
        "nested_fused": lambda t: L.quantize_params_4bit(t, fuse=True, compress_statistics=True),
        "int8": L.quantize_params_int8,
        "bf16_storage": lambda t: {**t, "layers": [quantize_2d(layer) for layer in t["layers"]]},
    }
    formats = {"npz": (S.save_checkpoint, S.load_checkpoint),
               "safetensors": (S.save_checkpoint_safetensors, S.load_checkpoint_safetensors)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_interop_")
    report, dq, seconds = {}, {}, {}
    try:
        for name, quantize in variants.items():
            t0 = time.perf_counter()
            g = quantize(gfloat)
            c = tree_to(g, "cpu")
            for fmt, (save, load) in formats.items():
                gp, cp = (os.path.join(tmp, f"{name}_{side}.{fmt}") for side in ("card", "cpu"))
                save(gp, g)
                save(cp, c)
                if fmt == "safetensors":
                    with open(gp, "rb") as fa, open(cp, "rb") as fb:
                        assert fa.read() == fb.read(), f"{name}: the card's and the CPU's files differ"
                else:  # a zip member carries its write time: compare the arrays
                    with np.load(gp) as za, np.load(cp) as zb:
                        assert za.files == zb.files and all(
                            za[k].dtype == zb[k].dtype and za[k].tobytes() == zb[k].tobytes() for k in za.files), name
                n1, bad1 = tree_mismatches(load(gp, c, device="cpu"), c)
                n2, bad2 = tree_mismatches(load(cp, g, device=dev), g)
                assert not bad1 and not bad2, f"{name} {fmt}: card->CPU {bad1[:4]}, CPU->card {bad2[:4]}"
                report[f"{name}_{fmt}"] = {"leaves": n1, "file_bytes": os.path.getsize(gp)}
            seconds[name] = time.perf_counter() - t0
            if name in ("nf4_fused", "bf16_storage"):  # kernel 10, plain (a paired payload repacked) and _dq
                t0 = time.perf_counter()
                reset_launch_counts()
                gd = dequantize_tree(g)
                counts = launch_counts()
                n, bad = tree_mismatches(gd, dequantize_tree(c))
                assert not bad, f"dequantize_tree {name}: {bad}"
                want = {k: 0 for k in counts}
                want["dequantize_4bit_2d" if name == "nf4_fused" else "dequantize_4bit_2d_dq"] = 4 * cfg.num_layers
                assert counts == want, f"dequantize_tree {name}: launch counts {counts}"
                dq[name] = {"leaves": n, "launches": {k: v for k, v in counts.items() if v},
                            "seconds": time.perf_counter() - t0}

        sd = hf_state_dict(cpu_float)
        imports = {}
        for mode in ("nf4", "fp4", "int8"):
            t0 = time.perf_counter()
            reset_launch_counts()
            gi = S.import_hf_llama(sd, cfg, quantize=mode, device=dev)
            counts = launch_counts()
            n, bad = tree_mismatches(gi, S.import_hf_llama(sd, cfg, quantize=mode, device="cpu"))
            assert not bad, f"import_hf_llama {mode}: {bad[:4]}"
            want = {k: 0 for k in counts}
            if mode != "int8":
                want["quantize_4bit_codes"] = 7 * cfg.num_layers
            assert counts == want, f"import_hf_llama {mode}: launch counts {counts}"
            imports[mode] = {"leaves": n, "launches": {k: v for k, v in counts.items() if v},
                             "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("cpu_check_interop", layers=cfg.num_layers, hidden=cfg.hidden_size, intermediate=cfg.intermediate_size,
         vocab=cfg.vocab_size, files=report, seconds_per_variant=seconds, dequantize_tree=dq,
         import_hf_llama=imports, bit_identical=True)
    torch.cuda.empty_cache()


def state_tensors(opt, params):
    """The state tensors of ``params`` in ``opt``, in order (no step counts)."""
    return [t for p in params for t in opt.state[p].values() if hasattr(t, "is_pinned")]


def paged_qlora(cfg, params, tids, ref, rank, alpha, chunk, steps):
    """4j: 4d's QLoRA training (the same double-quantized model, adapters
    from the same seed, the same ids) with ``paged_adamw8bit``, then
    ``adamw32bit`` and ``paged_adamw32bit``: each paged run's losses,
    adapters and states bit for bit the unpaged run's (``ref``: 4d's
    ``adamw8bit`` after its five steps), every state pinned in host memory,
    kernel 14 once a step; the step's wall time, the device memory between
    steps (``live_bytes``: the paged run holds at least 99% of the state
    bytes less) and at the peak against the unpaged run, and one more step under
    the profiler for the page-in and page-out copies (pinned to device and
    back; the page-in's count includes kernel 14's descriptor table)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bitsandbytes_tpu_torch import optim as O
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = tids.device
    Lyr = cfg.num_layers
    runs, unpaged32 = {}, None
    for fname in ("paged_adamw8bit", "adamw32bit", "paged_adamw32bit"):
        base_live = live_bytes()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lora = L.add_lora(cfg, rank=rank, alpha=alpha, targets=LORA_TARGETS,
                          generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        lparams = L.lora_parameters(lora)
        opt = getattr(O, fname)(lparams, 1e-3)
        paged = fname.startswith("paged_")
        torch.cuda.synchronize()
        reset_launch_counts()
        losses, wall, between = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = L.lora_train_step(params, lora, opt, tids, cfg, token_chunk=chunk)
            losses.append(loss.item())  # synchronizes
            wall.append((time.perf_counter() - t0) * 1e3)
            between.append((torch.cuda.memory_allocated() - base, torch.cuda.memory_reserved()))
        live = live_bytes() - base_live
        counts = launch_counts()
        want = {k: 0 for k in counts}
        want["dequantize_paired_fast_dq"] = steps * (8 * Lyr - 1)
        if "8bit" in fname:
            want["optimizer_update_8bit"] = steps
        assert counts == want, f"4j {fname}: launch counts {counts} != {want}"
        peak = torch.cuda.max_memory_allocated() - base
        states = state_tensors(opt, lparams)
        state_bytes = sum(t.numel() * t.element_size() for t in states)
        assert all(t.is_pinned() for t in states) if paged else all(t.device == dev for t in states), fname
        if fname == "adamw32bit":
            unpaged32 = {"losses": losses, "adapters": [t.detach().clone() for t in lparams],
                         "states": [t.clone() for t in states], "between": between[-1][0], "live": live,
                         "reserved": between[-1][1], "peak": peak}
            runs[fname] = {"losses": losses, "step_ms": {"median_2_5": statistics.median(wall[1:]), "all": wall},
                           "state_bytes": state_bytes, "allocated_between_steps": between[-1][0],
                           "live_between_steps": live, "peak": peak}
            del lora, lparams, opt, states, loss
            continue
        want_ref = ref if fname == "paged_adamw8bit" else unpaged32
        assert losses == want_ref["losses"], f"4j {fname}: losses {losses} != {want_ref['losses']}"
        assert all(bits_equal(a.detach(), b) for a, b in zip(lparams, want_ref["adapters"])), f"4j {fname}: adapters"
        assert len(states) == len(want_ref["states"]) and all(
            bits_equal(a.to(dev), b) for a, b in zip(states, want_ref["states"])), f"4j {fname}: states"
        saved = want_ref["live"] - live
        assert saved >= 0.99 * state_bytes, f"4j {fname}: {saved} bytes freed between steps, states {state_bytes}"

        # one more step under the profiler: the page-in and page-out copies
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            L.lora_train_step(params, lora, opt, tids, cfg, token_chunk=chunk).item()
            prof_wall = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        copies = {}
        for e in events:
            for direction, key in (("page_in", "HtoD (Pinned -> Device)"), ("page_out", "DtoH (Device -> Pinned)")):
                if key in e.key:
                    c = copies.setdefault(direction, {"ms": 0.0, "copies": 0})
                    c["ms"] += self_dev_us(e) / 1e3
                    c["copies"] += e.count
        assert set(copies) == {"page_in", "page_out"}, f"4j {fname}: copies {[e.key for e in events][:20]}"
        for c in copies.values():
            c["gb_s"] = state_bytes / (c["ms"] * 1e-3) / 1e9
        dev_ms = sum(self_dev_us(e) for e in events) / 1e3
        runs[fname] = {
            "losses": losses, "bit_identical_to": "adamw8bit (4d)" if "8bit" in fname else "adamw32bit",
            "step_ms": {"median_2_5": statistics.median(wall[1:]), "all": wall},
            "launches_per_step": {k: v / steps for k, v in counts.items() if v},
            "state_tensors": len(states), "state_bytes": state_bytes, "all_pinned": True,
            "allocated_between_steps": between[-1][0], "reserved_between_steps": between[-1][1],
            "unpaged_allocated_between_steps": want_ref["between"], "live_between_steps": live,
            "unpaged_live_between_steps": want_ref["live"], "freed_between_steps": saved,
            "unpaged_reserved_between_steps": want_ref["reserved"],
            "peak": peak, "unpaged_peak": want_ref["peak"],
            "profiled_step": {"wall_ms": prof_wall, "device_ms": dev_ms, "copies": copies,
                              "page_share_of_device": sum(c["ms"] for c in copies.values()) / dev_ms}}
        del lora, lparams, opt, states, loss, prof
    emit("paged_qlora", config="llama3_8b", layers=Lyr, compress_statistics=True, lora_rank=rank, lora_alpha=alpha,
         batch=tids.shape[0], seq=tids.shape[1] - 1, steps=steps, unpaged_adamw8bit_step_ms=ref["step_ms"],
         runs=runs)
    del unpaged32
    torch.cuda.empty_cache()


def embeddings_8b(dev, V=32000, D=4096, F_=14336):
    """4k: the embeddings and the override optimizer at Llama-3-8B widths.
    ``EmbeddingNF4`` on [32000, 4096] (built by kernel 1; a lookup of 8 x
    128 ids is kernel 10 over [1024, 4096] rows), timed against
    ``F.embedding`` on the bf16 table and kernel 10 over the whole table;
    ``Embedding8bit`` on the same table; ``StableEmbedding`` and a
    ``Linear4bit`` gate [14336, 4096] with a trained bias, 3 steps of
    ``adamw`` under ``GlobalOptimManager`` (the embedding's table at 32
    bits, the rest 8-bit: kernel 14 once a step for each parameter type);
    ``OutlierAwareLinear`` on the gate's shape, topk 16, at M 8 and 2048
    against ``Linear8bitLt`` at threshold 0.  Every launch counted."""
    import torch
    import torch.nn.functional as F

    from bitsandbytes_tpu_torch import nn as N
    from bitsandbytes_tpu_torch import optim as O
    from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.ops.gemm4bit import dequantize_4bit_2d, dequantize_4bit_2d_plain
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time

    def counted(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in launch_counts().items() if v}

    def dev_ms(fn):
        return cuda_time(fn, flush_l2=True, hold=True)["median"]

    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, V, (8, 128), generator=gen, device=dev)
    emb, c_build = counted(lambda: N.EmbeddingNF4(V, D, dtype=torch.bfloat16, device=dev, generator=gen))
    assert c_build == {"quantize_4bit_codes": 1}, f"EmbeddingNF4 build: {c_build}"
    out, c_look = counted(lambda: emb(ids))
    assert c_look == {"dequantize_4bit_2d": 1}, f"EmbeddingNF4 lookup: {c_look}"
    st = emb.weight.state
    table = emb.weight.dequantize().to(torch.bfloat16)
    assert out.shape == (8, 128, D) and out.dtype == torch.bfloat16
    assert bits_equal(out, table[ids]), "the lookup differs from the whole table's rows"
    # kernel 10 alone on the gathered rows, and its plain version on the card
    flat = ids.reshape(-1)
    rows = emb.weight.data.reshape(V, D // 2)[flat].reshape(-1)
    absmax = st.absmax.reshape(V, D // st.blocksize)[flat].reshape(-1).contiguous()
    code = get_4bit_code("nf4", st.blocksize)
    k10 = lambda: dequantize_4bit_2d(rows, absmax, code, st.blocksize, (flat.numel(), D), torch.bfloat16)  # noqa: E731
    plain = dequantize_4bit_2d_plain(rows, absmax, tuple(code.tolist()), st.blocksize, (flat.numel(), D),
                                     torch.bfloat16)
    assert bits_equal(k10(), plain), "kernel 10 differs from its plain version on the rows"
    nbytes = rows.numel() + absmax.numel() * 4 + flat.numel() * D * 2
    b_ms, b_by = bound_ms(nbytes, 0, PEAK_BF16_FLOPS)
    lookup = {
        "ids": list(ids.shape), "module_ms": dev_ms(lambda: emb(ids)), "kernel10_rows_ms": dev_ms(k10),
        "plain_rows_ms": cuda_time(lambda: dequantize_4bit_2d_plain(
            rows, absmax, tuple(code.tolist()), st.blocksize, (flat.numel(), D), torch.bfloat16))["median"],
        "library_ms_F_embedding_bf16": dev_ms(lambda: F.embedding(ids, table)),
        "kernel10_whole_table_ms": dev_ms(lambda: emb.weight.dequantize()), "bytes": nbytes,
        "bound_ms": b_ms, "bound_by": b_by, "launches": c_look}
    del table, rows, absmax, plain
    e8, c8 = counted(lambda: N.Embedding8bit(V, D, dtype=torch.bfloat16, device=dev, generator=gen))
    out8, c8l = counted(lambda: e8(ids))
    assert not c8 and not c8l, f"Embedding8bit: {c8} {c8l}"
    ref8 = (e8.weight.CB[ids].float() * (e8.weight.SCB[ids][..., None] / 127.0)).to(torch.bfloat16)
    assert bits_equal(out8, ref8), "Embedding8bit lookup"
    int8_lookup = {"module_ms": dev_ms(lambda: e8(ids)), "resident_bytes": e8.weight.CB.numel() + 4 * V}
    nf4_bytes = emb.weight.data.numel() + st.absmax.numel() * 4
    del emb, e8, out, out8, ref8

    # StableEmbedding + Linear4bit gate under GlobalOptimManager
    model = torch.nn.Module()
    model.embedding = N.StableEmbedding(V, D, device=dev, generator=gen)
    model.gate = N.Linear4bit(D, F_, device=dev, generator=gen)
    model.gate.bias.requires_grad_(True)
    mgr = O.GlobalOptimManager.get_instance()
    mgr.initialize()
    mgr.register_module_override(model.embedding, "weight", {"optim_bits": 32})
    opt = mgr.build("adam", model, 1e-3, optim_bits=8, weight_decay=1e-2)
    mgr.initialize()
    losses, wall = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(3):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = model.gate(model.embedding(ids)).float().pow(2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
        wall.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v for k, v in launch_counts().items() if v}
    # forward and backward each dequantize the gate once (M 1024); kernel 14
    # once a step for the f32 norm and once for the bf16 bias
    want = {"dequantize_paired_fast": 6, "optimizer_update_8bit": 6}
    assert counts == want, f"4k override training: {counts} != {want}"
    dtypes = {n: opt.state[p]["state1"].dtype for n, p in model.named_parameters() if p.requires_grad}
    assert dtypes == {"embedding.weight": torch.float32, "embedding.norm.weight": torch.uint8,
                      "embedding.norm.bias": torch.uint8, "gate.bias": torch.uint8}, dtypes
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
    override = {"losses": losses, "step_ms": wall, "state_types": {k: str(v) for k, v in dtypes.items()},
                "launches": counts, "groups": [{"optim_bits": g["optim_bits"], "params": len(g["params"])}
                                               for g in opt.param_groups]}
    del model, opt, loss

    # OutlierAwareLinear against Linear8bitLt on one weight
    W = torch.randn(F_, D, generator=gen, device=dev) * D**-0.5
    oal = N.OutlierAwareLinear(D, F_, outlier_topk=16, device=dev, weight=W)
    lt = N.Linear8bitLt(D, F_, threshold=0.0, device=dev)
    lt.weight = N.Int8TensorState.quantize(W)
    outlier = {}
    for M in (8, 2048):
        x = torch.randn(M, D, generator=gen, device=dev).to(torch.bfloat16)
        (y, cy), (y8, c8) = counted(lambda: oal(x)), counted(lambda: lt(x))
        assert not cy and not c8, f"OutlierAwareLinear M {M}: {cy} {c8}"
        exact = x.float() @ W.t()
        err = (y.float() - exact).abs().max().item() / exact.abs().max().item()
        err8 = (y8.float() - exact).abs().max().item() / exact.abs().max().item()
        assert torch.isfinite(y).all() and err < 0.05, f"OutlierAwareLinear M {M}: {err}"
        outlier[f"M{M}"] = {"ms": dev_ms(lambda: oal(x)), "linear8bitlt_ms": dev_ms(lambda: lt(x)),
                            "bf16_matmul_ms": dev_ms(lambda: x @ W.t().to(torch.bfloat16)),
                            "rel_err": err, "linear8bitlt_rel_err": err8}
    emit("embeddings_8b", vocab=V, hidden=D, lookup_nf4=lookup, nf4_table_bytes=nf4_bytes, lookup_int8=int8_lookup,
         override_training=override, outlier_aware_linear=outlier)
    torch.cuda.empty_cache()


def opt125m_kernel_cases(tree, gen, dev):
    """4l's kernel checks, outside the counted forwards: every linear of
    every layer through kernel 2 at M 8 (bf16 A, as the forward gives it;
    the f32 output against the plain version at rel 1e-3, the bf16 output
    its cast, a second call bit for bit) and through kernel 3 (the bf16
    weight the M 4096 forward multiplies, bit for bit against the plain
    version and a second call).  K 768 splits into units of 128 columns,
    a per-split K no ragged case of 3e has."""
    import torch

    from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
    from bitsandbytes_tpu_torch.ops import gemm4bit_paired as PT

    cases, worst = {}, {}
    for li, layer in enumerate(tree["layers"]):
        for name in ("wqkv", "wo", "fc_in", "fc_out"):
            qt = layer[name]
            st = qt.state
            assert st.layout == "paired" and not st.inline_nested, f"4l {name}: {st.layout}"
            N, K = (int(s) for s in st.shape[-2:])
            bs, code = st.blocksize, get_4bit_code(st.quant_type, st.blocksize)
            units = PT._units(PT._code_tuple(code))
            P, am_t = qt.data.reshape(N // 2, K), st.dequant_absmax_t()
            A = torch.randn(8, K, generator=gen, device=dev).to(torch.bfloat16)
            out = PT.gemm_4bit_paired(A, P, am_t, code, bs, (N, K), out_dtype=torch.float32)
            ref = PT.gemm_4bit_paired_plain(A, P, am_t, units, bs)
            rel = ((out - ref).abs().max() / ref.abs().max()).item()
            assert rel <= 1e-3, f"4l layer {li} {name}: kernel 2 rel err {rel}"
            out_bf = PT.gemm_4bit_paired(A, P, am_t, code, bs, (N, K))
            assert torch.equal(out_bf, out.to(torch.bfloat16)), f"4l layer {li} {name}: kernel 2 bf16 output"
            assert torch.equal(out_bf, PT.gemm_4bit_paired(A, P, am_t, code, bs, (N, K))), \
                f"4l layer {li} {name}: kernel 2 a second call"
            Wk = PT.dequantize_paired_fast(P, am_t, code, bs, torch.bfloat16)
            assert bits_equal(Wk, PT.dequantize_paired_fast_plain(P, am_t, units, bs, torch.bfloat16)), \
                f"4l layer {li} {name}: kernel 3"
            assert bits_equal(Wk, PT.dequantize_paired_fast(P, am_t, code, bs, torch.bfloat16)), \
                f"4l layer {li} {name}: kernel 3 a second call"
            key = f"{name} N{N} K{K} bs{bs}"
            cases[key] = cases.get(key, 0) + 1
            worst[key] = max(worst.get(key, 0.0), rel)
    return {"layers": len(tree["layers"]), "checked": cases, "kernel2_M8_max_rel_err": worst,
            "kernel3_bits_equal": True}


def opt125m(dev, cfg=None):
    """4l: the GPT-2/OPT family at OPT-125M's widths, random weights from
    seed 0, in bf16, NF4 (kernel 2 at M 8, kernel 3 + matmul at M 8 x 512)
    and LLM.int8(): forward wall and device ms, tok/s, launches, resident
    bytes, the split plans of kernel 2 at K 768 and 3072.  Gates: every
    NF4 linear through kernels 2 and 3 against their plain versions
    (``opt125m_kernel_cases``); the NF4 logits within atol 0.1 / rtol 0.05 of the same weights dequantized and
    run through ``torch.matmul``, every greedy token in that run's top-5 (the
    kernels' check); the NF4 and int8 greedy tokens of the 8 x 512 run in
    the bf16 run's top-5 at 70% and 95% of the positions (random weights
    leave the logits small margins, so NF4's quantization moves some
    greedy tokens out of the bf16 top-5)."""
    import torch

    from bitsandbytes_tpu_torch.functional import gemm as G
    from bitsandbytes_tpu_torch.models import gpt2 as G2
    from bitsandbytes_tpu_torch.nn.parametrize import dequantize_tree
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.ops import gemm4bit_paired as PT

    cfg = cfg or G2.GPT2Config.opt125m()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = G2.init_params(cfg, gen, device=dev)
    shapes = {(8, 1): "kernel 2", (8, 512): "kernel 3 + matmul"}
    assert 8 < G.LARGE_M_THRESHOLD <= 8 * 512
    ids = {s: torch.randint(0, cfg.vocab_size, s, generator=gen, device=dev) for s in shapes}
    sms = PT._sm_count(dev.index or 0)
    D, F_ = cfg.hidden_size, cfg.intermediate_size
    plans = {name: PT.gemm_plan(8, n, k, 64, sms) for name, (n, k) in
             {"wqkv": (3 * D, D), "wo": (D, D), "fc_in": (F_, D), "fc_out": (D, F_)}.items()}
    out, ref = {}, {}
    for mode, quantize in (("bf16", lambda p: p), ("nf4", G2.quantize_params_4bit),
                           ("int8", G2.quantize_params_int8)):
        torch.cuda.synchronize()
        reset_launch_counts()
        tree = quantize(params)
        torch.cuda.synchronize()
        load = {k: v for k, v in launch_counts().items() if v}
        assert load == ({"quantize_4bit_codes": 4 * cfg.num_layers} if mode == "nf4" else {}), f"{mode}: {load}"
        res = {"resident_bytes": tree_bytes(tree), "load_launches": load}
        if mode == "nf4":
            dequant = dequantize_tree(tree)
            res["kernel_cases"] = opt125m_kernel_cases(tree, torch.Generator(device=dev).manual_seed(18), dev)
        for shape, route in shapes.items():
            x = ids[shape]
            torch.cuda.synchronize()
            reset_launch_counts()
            logits = G2.forward(tree, x, cfg)
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            want = {}
            if mode == "nf4":
                want = {("gemm_4bit_paired" if shape[1] == 1 else "dequantize_paired_fast"): 4 * cfg.num_layers}
            assert counts == want, f"4l {mode} {shape}: {counts} != {want}"
            assert logits.shape == (*shape, cfg.vocab_size) and torch.isfinite(logits).all(), f"4l {mode} {shape}"
            wall = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                G2.forward(tree, x, cfg)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            _, events, prof_wall = profiled(lambda: G2.forward(tree, x, cfg))
            dev_ms = sum(self_dev_us(e) for e in events) / 1e3
            entry = {"route": route if mode == "nf4" else "torch.matmul" if mode == "bf16" else "torch._int_mm",
                     "wall_ms": statistics.median(wall), "device_ms": dev_ms, "device_busy_share": dev_ms / prof_wall,
                     "tokens_per_s": shape[0] * shape[1] / (statistics.median(wall) * 1e-3), "launches": counts,
                     "by_class": by_class(events, [("gemm_4bit_paired", "kernel 2"),
                                                   ("dequantize_paired", "kernel 3")])}
            if mode == "bf16":
                ref[shape] = logits
            else:
                top5 = ref[shape].topk(5, dim=-1).indices
                hit = (top5 == logits.argmax(-1, keepdim=True)).any(-1).float().mean().item()
                entry["greedy_in_bf16_top5"] = hit
                entry["max_abs_logit_diff"] = (logits - ref[shape]).abs().max().item()
                if shape[1] > 1:  # 4096 positions: the share is stable there
                    gate = 0.70 if mode == "nf4" else 0.95
                    assert hit >= gate, f"4l {mode} {shape}: {hit} of the greedy tokens in the bf16 top-5 ({gate})"
                if mode == "nf4":  # the kernels' gate: the same NF4 weights dequantized, through torch.matmul
                    dq = G2.forward(dequant, x, cfg)
                    assert torch.allclose(logits, dq, atol=0.1, rtol=0.05), f"4l nf4 {shape}: against dequantized"
                    assert (dq.topk(5, dim=-1).indices == logits.argmax(-1, keepdim=True)).any(-1).all(), \
                        f"4l nf4 {shape}: top-5 of the dequantized weights"
                    entry["max_abs_diff_dequantized_bf16"] = (logits - dq).abs().max().item()
            res[f"{shape[0]}x{shape[1]}"] = entry
        out[mode] = res
        del tree
    emit("opt125m", config=dataclass_dict(cfg), kernel2_plans_M8=plans, modes=out)
    torch.cuda.empty_cache()


def dataclass_dict(cfg):
    import dataclasses

    return {k: str(v) if not isinstance(v, (int, float)) else v for k, v in dataclasses.asdict(cfg).items()}


def slice18_cpu_check(dev):
    """5h: this slice's paths at 2 layers and a quarter of the widths, card
    against CPU: ``GPT2Config.tiny()`` in NF4 (bytes bit for bit; logits at
    M 16 and 192 within atol 0.1 / rtol 0.05 and the card's greedy token in
    the CPU's top-5) and int8 (top-5, and within int8's own move of the
    logits, as 5f holds it); the embeddings and OutlierAwareLinear at a
    quarter of the Llama-3-8B widths (kernels 1 and 10 bit for bit); 3 steps
    of each paged optimizer, paged against unpaged on the card bit for bit
    and against the CPU (8-bit bit for bit, 32-bit within rtol 1e-6), every
    paged state pinned; then ``python -m bitsandbytes_tpu_torch`` as a
    subprocess, its exit code 0."""
    import torch

    from bitsandbytes_tpu_torch import nn as N
    from bitsandbytes_tpu_torch import optim as O
    from bitsandbytes_tpu_torch.models import gpt2 as G2
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = G2.GPT2Config.tiny()
    cpu_float = G2.init_params(cfg, torch.Generator().manual_seed(13), device="cpu")
    gfloat = tree_to(cpu_float, dev)
    gpt2 = {}
    for mode, quantize in (("nf4", G2.quantize_params_4bit), ("int8", G2.quantize_params_int8)):
        g, c = quantize(gfloat), quantize(cpu_float)
        n, bad = tree_mismatches(g, c)
        assert not bad, f"5h gpt2 {mode}: {bad[:4]}"
        for shape, route in (((2, 8), "gemm_4bit_paired"), ((4, 48), "dequantize_paired_fast")):
            x = torch.randint(0, cfg.vocab_size, shape, generator=torch.Generator().manual_seed(14))
            torch.cuda.synchronize()
            reset_launch_counts()
            gl = G2.forward(g, x.to(dev), cfg).cpu()
            counts = {k: v for k, v in launch_counts().items() if v}
            assert counts == ({route: 4 * cfg.num_layers} if mode == "nf4" else {}), f"5h gpt2 {mode}: {counts}"
            cl = G2.forward(c, x, cfg)
            diff = (gl - cl).abs().max().item()
            if mode == "nf4":
                assert torch.allclose(gl, cl, atol=0.1, rtol=0.05), f"5h gpt2 {mode} {shape}: logits"
            else:  # as 5f: within int8's own move of the logits on the CPU (a 1-ulp bf16 change moves a row's step)
                shift = (cl - G2.forward(cpu_float, x, cfg)).abs().max().item()
                assert diff <= shift, f"5h gpt2 int8 {shape}: card - CPU {diff} beyond int8's displacement {shift}"
            top5 = cl.topk(5, dim=-1).indices
            assert (top5 == gl.argmax(-1, keepdim=True)).any(-1).all(), f"5h gpt2 {mode} {shape}: top-5"
            gpt2[f"{mode}_{shape[0]}x{shape[1]}"] = {"max_abs_logit_diff": diff, "launches": counts, "leaves": n}
    V, D = 8000, 1024
    emb = {}
    for name, make in (("nf4", N.EmbeddingNF4), ("fp4", N.EmbeddingFP4), ("int8", N.Embedding8bit),
                       ("stable", N.StableEmbedding)):
        mg = make(V, D, device=dev, generator=torch.Generator(device=dev).manual_seed(15))
        mc = make(V, D, device="cpu", generator=torch.Generator().manual_seed(15))
        if name == "stable":  # the two generators draw different tables: carry the card's across
            mc.weight = torch.nn.Parameter(mg.weight.detach().cpu())
        elif name != "int8":
            W = torch.randn(V, D, generator=torch.Generator().manual_seed(16))
            mg.weight = N.QuantizedTensor.quantize(W.to(dev), quant_type=name, layout="2d")
            mc.weight = N.QuantizedTensor.quantize(W, quant_type=name, layout="2d")
            assert bits_equal(mg.weight.data.cpu(), mc.weight.data), f"5h {name}: kernel 1 bytes"
        else:
            mc.weight = N.Int8TensorState(CB=mg.weight.CB.cpu(), SCB=mg.weight.SCB.cpu())
        ids = torch.randint(0, V, (4, 64), generator=torch.Generator().manual_seed(17))
        torch.cuda.synchronize()
        reset_launch_counts()
        og = mg(ids.to(dev)).cpu()
        counts = {k: v for k, v in launch_counts().items() if v}
        oc = mc(ids)
        if name in ("nf4", "fp4"):
            assert counts == {"dequantize_4bit_2d": 1} and bits_equal(og, oc), f"5h {name}: {counts}"
        else:
            assert torch.allclose(og, oc, rtol=1e-5, atol=1e-5), f"5h {name}"
        emb[name] = {"max_abs_diff": (og - oc).abs().max().item(), "launches": counts}
    Wo = torch.randn(D, D, generator=torch.Generator().manual_seed(18)) * D**-0.5
    og_lin = N.OutlierAwareLinear(D, D, outlier_topk=16, device=dev, weight=Wo.to(dev))
    oc_lin = N.OutlierAwareLinear(D, D, outlier_topk=16, device="cpu", weight=Wo)
    assert torch.equal(og_lin.outlier_idx.cpu(), oc_lin.outlier_idx) and bits_equal(og_lin.weight.CB.cpu(),
                                                                                    oc_lin.weight.CB)
    xo = torch.randn(64, D, generator=torch.Generator().manual_seed(19))
    yo_g, yo_c = og_lin(xo.to(dev)).float().cpu(), oc_lin(xo).float()
    assert torch.allclose(yo_g, yo_c, rtol=2 ** -7, atol=1e-2), "5h OutlierAwareLinear"
    emb["outlier_aware_linear"] = {"max_abs_diff": (yo_g - yo_c).abs().max().item()}

    paged = {}
    shapes = [(D // 4 * 7, D), (D,), ()]  # a gate-sized tensor at a quarter width, a bias, a scale
    for fname, unpaged, kw, kern in (
            ("paged_adamw8bit", "adamw8bit", {}, "optimizer_update_8bit"),
            ("paged_adamw32bit", "adamw32bit", {}, None),
            ("paged_lion8bit", "lion8bit", {}, "optimizer_update_8bit"),
            ("paged_ademamix8bit", "ademamix8bit", {"t_alpha": 1000, "t_beta3": 1000},
             "optimizer_update_8bit_ademamix")):
        g0 = torch.Generator().manual_seed(20)
        p0 = [torch.randn(s, generator=g0) for s in shapes]
        runs = {}
        for tag, factory, where in ((fname, fname, dev), (unpaged, unpaged, dev), ("cpu", fname, "cpu")):
            ps = [torch.nn.Parameter(p.clone().to(where)) for p in p0]
            opt = getattr(O, factory)(ps, 1e-3, **kw)
            gg = torch.Generator().manual_seed(21)
            torch.cuda.synchronize()
            reset_launch_counts()
            for _ in range(3):
                for p in ps:
                    p.grad = (torch.randn(p.shape, generator=gg) * 0.01).to(where)
                opt.step()
            torch.cuda.synchronize()
            runs[tag] = (ps, opt, {k: v for k, v in launch_counts().items() if v})
        (pp, po, pc), (up, uo, _), (cp, co, _) = runs[fname], runs[unpaged], runs["cpu"]
        if kern:
            assert pc == {kern: 3}, f"5h {fname}: {pc}"
        else:
            assert not pc, f"5h {fname}: {pc}"
        ps_states, us_states, cs_states = (state_tensors(o, p) for o, p in ((po, pp), (uo, up), (co, cp)))
        assert all(t.is_pinned() for t in ps_states), f"5h {fname}: a state is not pinned"
        assert all(bits_equal(a.detach().cpu(), b.detach().cpu()) for a, b in zip(pp, up)), f"5h {fname}: params"
        assert all(bits_equal(a, b.cpu()) for a, b in zip(ps_states, us_states)), f"5h {fname}: states"
        for a, b in zip(ps_states, cs_states):
            if a.dtype == torch.uint8 or "8bit" in fname:
                assert bits_equal(a, b), f"5h {fname}: a state differs from the CPU's"
            else:
                assert torch.allclose(a, b, rtol=1e-6, atol=0), f"5h {fname}: a 32-bit state"
        p_err = max((a.detach().cpu() - b.detach()).abs().max().item() for a, b in zip(pp, cp))
        assert p_err <= 1e-6, f"5h {fname}: parameters {p_err} from the CPU's"
        paged[fname] = {"launches": pc, "state_tensors": len(ps_states), "max_abs_param_diff_cpu": p_err}

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "bitsandbytes_tpu_torch"], cwd=os.path.dirname(os.path.abspath(
        __file__)), capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "Installation looks healthy" in res.stdout, res.stdout[-2000:] + res.stderr[-2000:]
    emit("cpu_check_slice18", gpt2=gpt2, embeddings=emb, paged=paged,
         diagnostics={"returncode": res.returncode, "seconds": time.perf_counter() - t0,
                      "last_lines": res.stdout.strip().splitlines()[-4:]})
    torch.cuda.empty_cache()


# -- slice 19: the host quantizer, MoE, the mesh -------------------------------


def host_quantizer(dev):
    """3o: ``utils/native.quantize_4bit_host`` (C++ and OpenMP on the host) of
    the f32 gate_up [28672, 4096] (470 MB) against kernel 1 on the card,
    codes and absmax bit for bit, nf4 and fp4 at blocksize 64 with no nested
    absmax; the host seconds beside kernel 1's device ms."""
    import numpy as np
    import torch

    from bitsandbytes_tpu_torch.functional.fourbit import quantize_4bit
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.ops.quant4bit import quantize_4bit_codes
    from bitsandbytes_tpu_torch.utils import native
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time

    t0 = time.perf_counter()
    assert native.available(), "3o: the host quantizer did not build (g++)"
    build_s = time.perf_counter() - t0
    N, K = LINEARS["gate_up"]
    W = torch.randn(N, K, generator=torch.Generator(device=dev).manual_seed(19), device=dev)
    W_host = W.cpu().numpy()
    out = {}
    for qt in ("nf4", "fp4"):
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            packed, absmax = native.quantize_4bit_host(W_host, 64, qt)
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        reset_launch_counts()
        p, st = quantize_4bit(W, blocksize=64, quant_type=qt, layout="flat")
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        assert counts == {"quantize_4bit_codes": 1}, f"3o {qt}: {counts}"
        assert np.array_equal(p.cpu().numpy().reshape(-1), packed), f"3o {qt}: codes differ from kernel 1"
        assert np.array_equal(st.absmax.cpu().numpy().view(np.uint32), absmax.view(np.uint32)), f"3o {qt}: absmax"
        flat = W.reshape(-1)
        t = cuda_time(lambda: quantize_4bit_codes(flat, qt, 64), n=10, flush_l2=True, hold=True)
        hs = statistics.median(host)
        out[qt] = {"host_s": {"median": hs, "min": min(host), "max": max(host), "n": 3},
                   "host_gb_s": W_host.nbytes / hs / 1e9, "kernel1_device_ms": t["median"],
                   "kernel1_host_held_out": t["host_ms"] < t["spin_ms"], "host_over_device": hs * 1e3 / t["median"],
                   "launches": counts}
    emit("host_quantizer", shape=[N, K], dtype="float32", blocksize=64, build_or_load_s=build_s,
         host_threads=native._lib().bnb_tpu_num_threads(), cpu_count=os.cpu_count(), bit_identical=True, modes=out)
    del W, W_host
    torch.cuda.empty_cache()


def one_rank_mesh():
    """A one-rank NCCL process group on the card (address and port given
    here: nothing on the machine names a cluster) and a ``{"data": 1,
    "model": 1}`` mesh over it; its collectives run through NCCL."""
    import socket

    import torch
    import torch.distributed as dist

    from bitsandbytes_tpu_torch.parallel import make_mesh

    if not dist.is_initialized():
        torch.cuda.set_device(0)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    return make_mesh({"data": 1, "model": 1})


def counted_collectives(mesh):
    """Count ``mesh``'s all_gather and all_reduce calls: a dict that the
    wrapped methods add to."""
    calls = {"all_gather": 0, "all_reduce": 0}
    for name in calls:
        orig = getattr(mesh, name)

        def wrap(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        setattr(mesh, name, wrap)
    return calls


def sharded_serving(cfg, params, ids, prompts, dev):
    """4n: serving over a mesh at one rank, on 4a's model: a real NCCL
    group, so every collective runs.  Prefill and 8 greedy decode steps with
    ``mesh=`` (``llama_param_specs``, ``shard_kv_cache``) against the same
    run without: logits bit for bit, the same tokens and kernel launches,
    and the count of collectives; then the engine with ``mesh=`` against
    the engine without (bf16 dense and paged pools): the same streams and
    launches.  Then virtual meshes of 2 and 4 ranks: every rank's shard of
    layer 0's wo and down and of the lm_head (quantized here, as
    ``quantize_lm_head=True`` does) through kernel 2 at M 8 (f32 output,
    against its slice of the full weight's within 1e-3 relative, kernel
    2's ragged-shape tolerance: a shard's split plan may differ) and kernel
    3 (bit for bit its slice), and a double-quantized wo's shards through
    kernels 5 and 6 the same way."""
    import torch

    from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.ops import gemm4bit_paired as PT
    from bitsandbytes_tpu_torch.parallel import (
        Sharded,
        llama_param_specs,
        make_mesh,
        shard_kv_cache,
        shard_quantized_tree,
    )
    from bitsandbytes_tpu_torch.serving import ContinuousBatchingEngine

    mesh = one_rank_mesh()
    calls = counted_collectives(mesh)
    sparams = llama_param_specs(mesh, params)
    n_sharded = sum(isinstance(v, Sharded) for layer in sparams["layers"] for v in layer.values()) + sum(
        isinstance(sparams[k], Sharded) for k in ("embed", "lm_head"))
    steps, max_len = 8, 256
    runs = {}
    # the mesh run twice: the first use of the groups sets up their NCCL communicators
    for tag, tree, m in (("unsharded", params, None), ("mesh", sparams, mesh), ("mesh_again", sparams, mesh)):
        torch.cuda.synchronize()
        reset_launch_counts()
        calls.update(all_gather=0, all_reduce=0)
        t0 = time.perf_counter()
        cache = L.init_kv_cache(cfg, ids.shape[0], max_len, device=dev)
        if m is not None:
            cache = shard_kv_cache(cache, m)
        logits, cache = L.prefill(tree, ids, cfg, cache, mesh=m)
        outs, tok = [logits], logits[:, -1].argmax(-1)
        toks = [tok]
        for s in range(steps):
            logits, cache = L.decode_step(tree, tok, cfg, cache, ids.shape[1] + s, mesh=m)
            tok = logits.argmax(-1)
            outs.append(logits)
            toks.append(tok)
        torch.cuda.synchronize()
        runs[tag] = {"outs": outs, "toks": torch.stack(toks, 1), "wall_s": time.perf_counter() - t0,
                     "counts": {k: v for k, v in launch_counts().items() if v}, "collectives": dict(calls)}
        del cache
    u, s_ = runs["unsharded"], runs["mesh"]
    for tag in ("mesh", "mesh_again"):
        assert torch.equal(u["toks"], runs[tag]["toks"]), f"4n {tag}: greedy tokens with mesh= differ"
        assert all(bits_equal(a, b) for a, b in zip(u["outs"], runs[tag]["outs"])), f"4n {tag}: logits differ"
        assert u["counts"] == runs[tag]["counts"], f"4n {tag}: launches {runs[tag]['counts']} != {u['counts']}"
    Lyr = cfg.num_layers
    # a forward gathers wo's and down's outputs in every layer and the lm_head's
    # (the fused wqkv and gate_up replicate), and sums the embedding once
    want_calls = {"all_gather": (steps + 1) * (2 * Lyr + 1), "all_reduce": steps + 1}
    assert s_["collectives"] == want_calls, f"4n: collectives {s_['collectives']} != {want_calls}"

    # one collective's host cost: a decode step's gathered output [8, 4096] bf16, after a warm-up
    def per_call_ms(fn, n=200):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    xg = torch.randn(ids.shape[0], cfg.hidden_size, generator=torch.Generator(device=dev).manual_seed(25),
                     device=dev).to(torch.bfloat16)
    xr = xg.to(torch.float32)
    collective_ms = {"all_gather": per_call_ms(lambda: mesh.all_gather(xg, "model", dim=-1)),
                     "all_reduce": per_call_ms(lambda: mesh.all_reduce(xr, "model")),
                     "clone": per_call_ms(lambda: xg.clone())}

    engine = {}
    for layout in ("dense", "paged"):
        res = {}
        for tag, m in (("unsharded", None), ("mesh", mesh)):
            torch.cuda.synchronize()
            reset_launch_counts()
            calls.update(all_gather=0, all_reduce=0)
            t0 = time.perf_counter()
            eng = ContinuousBatchingEngine(params, cfg, max_batch=4, max_len=256, kv_layout=layout,
                                           kv_block_size=128, steps_per_sync=8, mesh=m, device=dev)
            out = eng.generate([p[:100] for p in prompts[:6]], max_new_tokens=16)
            torch.cuda.synchronize()
            res[tag] = {"streams": [r.tokens for r in out], "wall_s": time.perf_counter() - t0,
                        "launches": {k: v for k, v in launch_counts().items() if v}, "collectives": dict(calls)}
            del eng
        assert res["mesh"]["streams"] == res["unsharded"]["streams"], f"4n engine {layout}: streams differ"
        assert res["mesh"]["launches"] == res["unsharded"]["launches"], f"4n engine {layout}: launches differ"
        assert res["mesh"]["collectives"]["all_gather"] > 0
        engine[layout] = {"streams_equal": True, "first_stream": res["mesh"]["streams"][0][:8],
                          "wall_s": {t: r["wall_s"] for t, r in res.items()}, "launches": res["mesh"]["launches"],
                          "collectives": res["mesh"]["collectives"]}
    torch.cuda.empty_cache()

    # every virtual rank's shard through kernels 2 and 3, then a nested shard through 5 and 6
    gen = torch.Generator(device=dev).manual_seed(20)
    layer0 = params["layers"][0]
    weights = {"wo": layer0["wo"], "down": layer0["down"],
               "lm_head": QuantizedTensor.quantize(params["lm_head"], blocksize=64)}
    wo_bf16 = weights["wo"].dequantize().to(torch.bfloat16)
    weights["wo_nested"] = QuantizedTensor.quantize(wo_bf16, blocksize=64, compress_statistics=True)
    sms = PT._sm_count(dev.index or 0)
    torch.cuda.synchronize()
    reset_launch_counts()
    shards = {}
    for name, qt in weights.items():
        st = qt.state
        N, K = (int(d) for d in st.shape)
        bs, code = st.blocksize, get_4bit_code(st.quant_type, st.blocksize)
        A = torch.randn(8, K, generator=gen, device=dev).to(torch.bfloat16)
        P = qt.data.reshape(N // 2, K)
        nested = st.nested
        if nested:
            sc = (st.absmax, st.state2.absmax, st.offset)
            full = PT.gemm_4bit_paired_dq(A, P, *sc, code, bs, (N, K), out_dtype=torch.float32)
            full_w = PT.dequantize_paired_fast_dq(P, *sc, code, bs, torch.bfloat16)
        else:
            full = PT.gemm_4bit_paired(A, P, st.absmax, code, bs, (N, K), out_dtype=torch.float32)
            full_w = PT.dequantize_paired_fast(P, st.absmax, code, bs, torch.bfloat16)
        per = {}
        for s in (2, 4):
            worst, plans, equal_slices = 0.0, set(), 0
            for r in range(s):
                sh = shard_quantized_tree({"w": qt}, make_mesh({"model": s}, coord=r), lambda p, l: ("model", None))
                c = sh["w"].compute
                Ns = N // s
                cs = c.state
                Pc = c.data.reshape(Ns // 2, K)
                assert tuple(cs.shape) == (Ns, K) and cs.nested == nested and (not nested or cs.inline_nested), \
                    f"4n {name}: shard state {cs.shape}"
                if nested:
                    sc_ = (cs.absmax, cs.state2.absmax, cs.offset)
                    part = PT.gemm_4bit_paired_dq(A, Pc, *sc_, code, bs, (Ns, K), out_dtype=torch.float32)
                    part_w = PT.dequantize_paired_fast_dq(Pc, *sc_, code, bs, torch.bfloat16)
                else:
                    part = PT.gemm_4bit_paired(A, Pc, cs.absmax, code, bs, (Ns, K), out_dtype=torch.float32)
                    part_w = PT.dequantize_paired_fast(Pc, cs.absmax, code, bs, torch.bfloat16)
                ref = full[:, r * Ns : (r + 1) * Ns]
                rel = ((part - ref).abs().max() / ref.abs().max()).item()
                assert rel <= 1e-3, f"4n {name} {s} ranks, rank {r}: kernel {5 if nested else 2} rel err {rel}"
                assert bits_equal(part_w, full_w[r * Ns : (r + 1) * Ns]), \
                    f"4n {name} {s} ranks, rank {r}: kernel {6 if nested else 3} is not its slice"
                worst = max(worst, rel)
                equal_slices += int(bits_equal(part, ref))
                plans.add(PT.gemm_plan(8, Ns, K, bs, sms))
            per[f"{s}_ranks"] = {"rows_per_rank": N // s, "max_rel_err_M8": worst, "plans": sorted(plans),
                                 "ranks_bit_equal_to_slice": equal_slices}
        shards[name] = {"shape": [N, K], "nested": nested, "full_plan": PT.gemm_plan(8, N, K, bs, sms), **per}
    torch.cuda.synchronize()
    shard_counts = {k: v for k, v in launch_counts().items() if v}
    for k in ("gemm_4bit_paired", "dequantize_paired_fast", "gemm_4bit_paired_dq", "dequantize_paired_fast_dq"):
        assert shard_counts.get(k, 0) > 0, f"4n: {k} never ran on a shard"
    emit("sharded_serving", config="llama3_8b", layers=Lyr, mesh={"data": 1, "model": 1}, backend="nccl",
         sharded_leaves=n_sharded, batch=ids.shape[0], prompt=ids.shape[1], steps=steps, max_len=max_len,
         tokens_equal=True, logits_bit_equal=True, first_tokens=s_["toks"][0].tolist(),
         wall_s={t: r["wall_s"] for t, r in runs.items()}, launches=s_["counts"], collectives=s_["collectives"],
         collective_host_ms=collective_ms,
         engine=engine, virtual_shards=shards, shard_launches=shard_counts)
    del sparams, weights, wo_bf16, full, full_w
    torch.cuda.empty_cache()
    return s_["counts"]


def moe_mixtral(dev, canary_bs, hidden=4096, ffn=14336):
    """4m: one MoE layer at Mixtral-8x7B's widths (``mistralai/Mixtral-8x7B-v0.1``
    config.json: hidden 4096, intermediate_size 14336, num_local_experts 8,
    num_experts_per_tok 2), NF4 blocksize 64, random weights from seed 0,
    ``init_moe_params`` on the card (kernel 1, 16 times); bf16 x at M 8
    (kernel 2, 16 launches) and M 1024 (kernel 3 + ``torch.matmul``).  Device
    ms with the L2 flushed and the host held out, launches, resident bytes,
    the bound; the library column: the same experts dequantized to bf16 (2.82
    GB) through ``torch.matmul``, against which the output holds within 4l's
    tolerance (atol 0.1 / rtol 0.05).  The gates against the CPU's bit for
    bit; expert parallelism at one NCCL rank against the dense layer."""
    import torch

    from bitsandbytes_tpu_torch.functional import gemm as G
    from bitsandbytes_tpu_torch.functional.quant_state import QuantState
    from bitsandbytes_tpu_torch.models import moe as M
    from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.parallel import make_mesh
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time, sol_fraction

    E, top_k = 8, 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.perf_counter()
    params, meta = M.init_moe_params(hidden, ffn, E, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    load = {k: v for k, v in launch_counts().items() if v}
    assert load == {"quantize_4bit_codes": 2 * E}, f"4m load: {load}"
    assert meta["gate_up"][3] == meta["down"][3] == "paired"
    resident = tree_bytes(params)
    expert_bytes = sum(params[k].numel() * params[k].element_size() for k in params if k != "router")

    def bf16_weight(name, e):
        qt, bs, shape, layout = meta[name]
        st = QuantState.make(absmax=params[name + "_absmax"][e], shape=shape, quant_type=qt, blocksize=bs,
                             dtype=torch.bfloat16, layout=layout)
        return QuantizedTensor(data=params[name + "_data"][e], state=st).dequantize()

    W_gu = [bf16_weight("gate_up", e) for e in range(E)]
    W_dn = [bf16_weight("down", e) for e in range(E)]
    lib_bytes = sum(w.numel() * w.element_size() for w in W_gu + W_dn)

    def library(x):
        gates = M.moe_gates(x, params["router"], top_k)
        out = torch.zeros(x.shape[0], hidden, dtype=torch.float32, device=dev)
        for e in range(E):
            g, u = torch.chunk(torch.matmul(x, W_gu[e].t()), 2, dim=-1)
            h = (torch.nn.functional.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
            out += gates[:, e : e + 1] * torch.matmul(h, W_dn[e].t()).to(torch.float32)
        return out.to(x.dtype)

    gen = torch.Generator(device=dev).manual_seed(21)
    res = {}
    one_rank_mesh()
    mesh = make_mesh({"expert": 1})
    for Mrows in (8, 1024):
        x = torch.randn(Mrows, hidden, generator=gen, device=dev).to(torch.bfloat16)
        torch.cuda.synchronize()
        reset_launch_counts()
        y = M.moe_ffn(params, meta, x, top_k=top_k)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        small = Mrows < G.LARGE_M_THRESHOLD
        want = {("gemm_4bit_paired" if small else "dequantize_paired_fast"): 2 * E}
        assert counts == want, f"4m M {Mrows}: {counts} != {want}"
        assert y.shape == x.shape and torch.isfinite(y.float()).all()
        ref = library(x)
        assert torch.allclose(y.float(), ref.float(), atol=0.1, rtol=0.05), f"4m M {Mrows}: against bf16 experts"
        g_dev = M.moe_gates(x, params["router"], top_k).cpu()
        g_cpu = M.moe_gates(x.cpu(), params["router"].cpu(), top_k)
        assert bits_equal(g_dev, g_cpu), f"4m M {Mrows}: gates differ from the CPU's"
        ep = M.moe_ffn_expert_parallel(params, meta, x, mesh, axis="expert", top_k=top_k)
        assert bits_equal(ep, y), f"4m M {Mrows}: expert-parallel at one rank differs from dense"
        t = cuda_time(lambda: M.moe_ffn(params, meta, x, top_k=top_k), n=10, flush_l2=True, hold=True,
                      hold_cycles=20_000_000)
        t_lib = cuda_time(lambda: library(x), n=10, flush_l2=True, hold=True, hold_cycles=20_000_000)
        io = 2 * x.numel() * x.element_size() + params["router"].numel() * 4
        nbytes = expert_bytes + io
        ops = 2 * Mrows * E * (2 * ffn * hidden + hidden * ffn)
        b_ms, b_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
        res[f"M{Mrows}"] = {
            "route": "kernel 2" if small else "kernel 3 + torch.matmul", "launches": counts,
            "device_ms": t["median"], "device_ms_min_max": [t["min"], t["max"]],
            "host_held_out": t["host_ms"] < t["spin_ms"], "bytes": nbytes, "ops": ops, "bound_ms": b_ms,
            "bound_by": b_by, "canary_bound_ms": nbytes / canary_bs * 1e3,
            "canary_sol_fraction": sol_fraction(t["median"] * 1e-3, nbytes, canary_bs / 1e9),
            "library_ms": t_lib["median"], "library_bytes": lib_bytes + io,
            "max_abs_diff_bf16_experts": (y.float() - ref.float()).abs().max().item(),
            "experts_per_token": (g_dev > 0).sum(-1).float().mean().item()}
    emit("moe_mixtral", source="mistralai/Mixtral-8x7B-v0.1 config.json", hidden=hidden, ffn=ffn, experts=E,
         top_k=top_k, quant_type="nf4", blocksize=64, layers=1, init_s=init_s, load_launches=load,
         resident_bytes=resident, expert_bytes=expert_bytes, held_before=held,
         peak_memory=torch.cuda.max_memory_allocated(), gates_bit_equal_cpu=True, expert_parallel_one_rank=True,
         results=res)
    del params, W_gu, W_dn
    torch.cuda.empty_cache()
    return res


def slice19_cpu_check(dev):
    """5i: this slice's paths at small size, card against CPU: the MoE at
    hidden 256 (4 experts, top 2, bf16 x at M 8 and 160: kernel 2, then 3 +
    matmul) within 0.03 / 0.05 of the CPU's plain versions and the gates bit
    for bit; the sharded forward of a 2-layer Llama at a quarter of the
    widths over the one-rank NCCL mesh against the CPU's unsharded forward
    (5's logits gate: atol 0.1 / rtol 0.05, the card's greedy token in the
    CPU's top-5); expert parallelism at one rank against dense."""
    import torch

    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.models import moe as M
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.parallel import llama_param_specs, make_mesh

    t0 = time.perf_counter()
    cpu_p, meta = M.init_moe_params(256, 256, 4, generator=torch.Generator().manual_seed(22), device="cpu")
    dev_p = {k: v.to(dev) for k, v in cpu_p.items()}
    moe = {}
    one_rank_mesh()
    emesh = make_mesh({"expert": 1})
    reset_launch_counts()
    for Mrows in (8, 160):
        x = torch.randn(Mrows, 256, generator=torch.Generator().manual_seed(Mrows)).to(torch.bfloat16)
        yc = M.moe_ffn(cpu_p, meta, x, top_k=2)
        yg = M.moe_ffn(dev_p, meta, x.to(dev), top_k=2)
        ep = M.moe_ffn_expert_parallel(dev_p, meta, x.to(dev), emesh, top_k=2)
        assert torch.allclose(yg.float().cpu(), yc.float(), atol=0.03, rtol=0.05), f"5i moe M {Mrows}"
        assert bits_equal(ep, yg), f"5i moe M {Mrows}: expert-parallel at one rank"
        assert bits_equal(M.moe_gates(x.to(dev), dev_p["router"], 2).cpu(), M.moe_gates(x, cpu_p["router"], 2))
        moe[f"M{Mrows}"] = (yg.float().cpu() - yc.float()).abs().max().item()
    moe_counts = {k: v for k, v in launch_counts().items() if v}
    assert moe_counts.get("gemm_4bit_paired", 0) >= 8 and moe_counts.get("dequantize_paired_fast", 0) >= 8, \
        moe_counts

    cfg = L.LlamaConfig(vocab_size=8000, hidden_size=1024, intermediate_size=3584, num_layers=2, num_heads=8,
                        num_kv_heads=2, head_dim=128)
    cpu_t = L.quantize_params_4bit(L.init_params(cfg, torch.Generator().manual_seed(23), device="cpu"))
    dev_t = tree_to(cpu_t, dev)
    mesh = one_rank_mesh()
    ids = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(24))
    with torch.no_grad():
        lc, _ = L.forward(cpu_t, ids, cfg)
        reset_launch_counts()
        lg, _ = L.forward(llama_param_specs(mesh, dev_t), ids.to(dev), cfg, mesh=mesh)
        fwd_counts = {k: v for k, v in launch_counts().items() if v}
    lg = lg.cpu()
    assert torch.allclose(lg, lc, atol=0.1, rtol=0.05), "5i sharded forward against the CPU"
    assert (lc.topk(5, dim=-1).indices == lg.argmax(-1, keepdim=True)).any(-1).all(), "5i sharded forward top-5"
    emit("cpu_check_slice19", moe_max_abs_diff=moe, moe_launches=moe_counts,
         sharded_forward={"layers": 2, "hidden": cfg.hidden_size, "max_abs_logit_diff": (lg - lc).abs().max().item(),
                          "launches": fwd_counts},
         seconds=time.perf_counter() - t0)


# -- slice 20: training over a mesh -------------------------------------------


def events_fwd_bwd(f, inputs, gout, n=5):
    """Forward and backward of ``f(*inputs)`` against the cotangent
    ``gout``: ms between CUDA events around each (a spin queued first, so the
    host runs ahead of the card), median and range of ``n`` after a warm-up,
    and the peak memory allocated above what was held before."""
    import torch

    fwd, bwd = [], []
    base = peak = 0
    for i in range(n + 1):
        for t in inputs:
            t.grad = None
        torch.cuda.synchronize()
        if i == 1:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda._sleep(2_000_000)
        e0.record()
        out = f(*inputs)
        e1.record()
        out.backward(gout)
        e2.record()
        e2.synchronize()
        if i:
            fwd.append(e0.elapsed_time(e1))
            bwd.append(e1.elapsed_time(e2))
        del out
    peak = torch.cuda.max_memory_allocated() - base
    return {"fwd_ms": statistics.median(fwd), "fwd_range": [min(fwd), max(fwd)], "bwd_ms": statistics.median(bwd),
            "bwd_range": [min(bwd), max(bwd)], "n": n, "peak_bytes": peak}


def wall_and_device(fn, n=3):
    """``fn()`` timed: the host clock over ``n`` runs after a warm-up, each
    ending in a synchronize (median and range), then one run under
    ``torch.profiler`` for the sum of its device events, also by class."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    _, events, prof_wall = profiled(fn)
    dev_ms = sum(self_dev_us(e) for e in events) / 1e3
    classes = by_class(events, [("nccl", "NCCL collectives"), ("dequantize_paired", "kernels 3 and 6"),
                                ("gemm_4bit_paired_nt", "kernel 7"), ("gemm_4bit_paired", "kernel 2"),
                                ("optimizer_update_8bit", "kernel 14")])
    return {"wall_ms": statistics.median(walls), "wall_range": [min(walls), max(walls)], "device_ms": dev_ms,
            "profiled_wall_ms": prof_wall, "device_busy_share": dev_ms / prof_wall, "by_class": classes}


def rel_err(a, b):
    """max |a - b| over max |b|, in f32."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def ring_and_pipeline(dev, H=32, KVH=8, hd=128, T=4096, D=4096, n_layers=32):
    """4o: ring attention and GPipe at Llama-3-8B widths on the one-rank
    NCCL group.  Ring attention: H 32 (8 KV heads repeated), hd 128, B 1, T
    4096, bf16 q/k/v; the one-rank ring, forward and backward, against the
    dense f32 oracle (``models/llama._attention``), SDPA with
    ``is_causal`` and the model's flash route (kernels 17-19): the errors of
    the output and of dq/dk/dv, the ms of each direction and the peak memory
    of all four; then every rank of rings of
    2 and 4 computed in one process (``ring_attention_local`` on f32 copies)
    against the one-rank ring on the same copies, within 2e-5 relative,
    causal and not.  GPipe: 32 NF4 blocksize-64 [4096, 4096] layers, each
    the residual gelu of ``matmul_4bit`` plus a float bias, x bf16 [64,
    4096] in 4 microbatches (M 16: kernel 2 forward, kernel 7 for grad_x):
    output, grad_x and the bias gradients bit for bit the same layers run
    microbatch by microbatch, and against one sequential pass over all 64
    rows within 5e-2 relative (kernel 2 cuts K by M); the launches of
    kernels 2 and 7 and the wall and device ms of the pipelined step against
    the sequential one."""
    import torch
    import torch.nn.functional as F

    from bitsandbytes_tpu_torch import autograd
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.parallel import (
        gpipe,
        make_mesh,
        ring_attention,
        ring_attention_local,
        stack_stage_params,
    )

    one_rank_mesh()
    mesh = make_mesh({"seq": 1})
    gen = torch.Generator(device=dev).manual_seed(30)
    B, G = 1, H // KVH
    q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
    k, v = (torch.randn(B, T, KVH, hd, generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
            for _ in range(2))
    gout = torch.randn(B, T, H * hd, generator=gen, device=dev).to(torch.bfloat16)
    cfg = L.LlamaConfig(num_heads=H, num_kv_heads=KVH, head_dim=hd)
    pos = torch.arange(T, device=dev)[None].expand(B, T)
    valid = torch.ones(B, T, dtype=torch.bool, device=dev)

    def ring(q, k, v):
        kr, vr = (torch.repeat_interleave(t, G, dim=2) for t in (k, v))
        return ring_attention(q, kr, vr, mesh, axis="seq").reshape(B, T, H * hd)

    def oracle(q, k, v):
        return L._attention(q, k, v, pos, valid, cfg)

    def sdpa(q, k, v):
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                                           enable_gqa=True)
        return o.transpose(1, 2).reshape(B, T, H * hd)

    def flash(q, k, v):  # kernels 17-19, the model's route at this shape
        return L._flash_attention_causal(q, k, v, cfg)

    assert L._flash_ok(cfg, T, hd, q.device)
    results, timing = {}, {}
    for name, f in (("ring", ring), ("oracle", oracle), ("sdpa", sdpa), ("flash", flash)):
        for t in (q, k, v):
            t.grad = None
        out = f(q, k, v)
        out.backward(gout)
        results[name] = [out.detach()] + [t.grad.clone() for t in (q, k, v)]
        del out
        timing[name] = events_fwd_bwd(f, (q, k, v), gout)
        torch.cuda.empty_cache()
    errs = {}
    for name in ("ring", "sdpa", "flash"):
        errs[name] = {key: (a.float() - b.float()).abs().max().item()
                      for key, a, b in zip(("out", "dq", "dk", "dv"), results[name], results["oracle"])}
        assert all(math.isfinite(e) for e in errs[name].values()), f"4o {name}: {errs[name]}"
    assert all(torch.isfinite(t).all() for t in results["ring"]), "4o: the ring's output or gradients are not finite"
    # the oracle rounds its probabilities to bf16 before the product with v: the ring and SDPA do not
    assert errs["ring"]["out"] <= 2e-2, f"4o ring output against the oracle: {errs['ring']}"
    for key, a, b in zip(("dq", "dk", "dv"), results["ring"][1:], results["oracle"][1:]):
        assert rel_err(a, b) <= 5e-2, f"4o ring {key} against the oracle: {rel_err(a, b)}"
    # the flash kernels round the unnormalized p to bf16, the oracle the probabilities: the ring's bounds
    assert errs["flash"]["out"] <= 2e-2, f"4o flash output against the oracle: {errs['flash']}"
    for key, a, b in zip(("dq", "dk", "dv"), results["flash"][1:], results["oracle"][1:]):
        assert rel_err(a, b) <= 5e-2, f"4o flash {key} against the oracle: {rel_err(a, b)}"

    # every rank of rings of 2 and 4 in one process, on f32 copies of the inputs
    with torch.no_grad():
        q32 = q.detach().float()
        k32, v32 = (torch.repeat_interleave(t.detach().float(), G, dim=2) for t in (k, v))
        virtual = {}
        for causal in (True, False):
            whole = ring_attention_local(q32, [(k32, v32)], 0, 1, causal)
            for n in (2, 4):
                Tl = T // n
                ks, vs = k32.split(Tl, dim=1), v32.split(Tl, dim=1)
                parts = [ring_attention_local(q32[:, r * Tl : (r + 1) * Tl],
                                              [(ks[(r - i) % n], vs[(r - i) % n]) for i in range(n)], r, n, causal)
                         for r in range(n)]
                err = rel_err(torch.cat(parts, dim=1), whole)
                assert err <= 2e-5, f"4o: {n} virtual ranks (causal {causal}) against one: {err}"
                virtual[f"{n}_ranks_{'causal' if causal else 'full'}"] = err
            del whole, parts
    del results, q32, k32, v32
    torch.cuda.empty_cache()

    # GPipe over 32 NF4 layers, one stage
    pmesh = make_mesh({"pipe": 1})
    M, rows = 4, 64
    layers = []
    for _ in range(n_layers):
        W = (torch.randn(D, D, generator=gen, device=dev) * D**-0.5).to(torch.bfloat16)
        layers.append({"w": QuantizedTensor.quantize(W, blocksize=64),
                       "b": torch.randn(D, generator=gen, device=dev) * 0.02})
    del W
    stacked = stack_stage_params(layers, 1)
    stacked["b"].requires_grad_()
    x = torch.randn(rows, D, generator=gen, device=dev).to(torch.bfloat16)
    gy = torch.randn(rows, D, generator=gen, device=dev).to(torch.bfloat16)

    def layer_fn(p, a):
        h = autograd.matmul_4bit(a, p["w"].data, p["w"].state)
        return (a + F.gelu(h.to(torch.float32) + p["b"], approximate="tanh")).to(a.dtype)

    def pipelined():
        stacked["b"].grad = None
        xg = x.clone().requires_grad_()
        y = gpipe(layer_fn, stacked, xg, pmesh, n_microbatches=M)
        y.backward(gy)
        return y.detach(), xg.grad, stacked["b"].grad[0]

    def sequential(xs, gys):
        """The layers over each row block of ``xs`` in turn (the last first,
        as the pipeline's backward runs them), the bias gradients summed in
        that order."""
        ys, dxs, db = [None] * len(xs), [None] * len(xs), torch.zeros_like(stacked["b"][0])
        for j in reversed(range(len(xs))):
            xj = xs[j].clone().requires_grad_()
            bias = [stacked["b"][0, i].detach().requires_grad_() for i in range(n_layers)]
            a = xj
            for i in range(n_layers):
                a = layer_fn({"w": layers[i]["w"], "b": bias[i]}, a)
            got = torch.autograd.grad(a, [xj] + bias, gys[j])
            ys[j], dxs[j] = a.detach(), got[0]
            db += torch.stack(got[1:])
        return torch.cat(ys), torch.cat(dxs), db

    torch.cuda.synchronize()
    reset_launch_counts()
    y, dx, db = pipelined()
    torch.cuda.synchronize()
    pipe_counts = {k_: c for k_, c in launch_counts().items() if c}
    want = {"gemm_4bit_paired": 2 * n_layers * M, "gemm_4bit_paired_nt": n_layers * M}
    assert pipe_counts == want, f"4o gpipe: launches {pipe_counts} != {want}"
    y_mb, dx_mb, db_mb = sequential(x.chunk(M), gy.chunk(M))
    assert bits_equal(y, y_mb) and bits_equal(dx, dx_mb) and bits_equal(db, db_mb), \
        "4o gpipe: not the layers' bits microbatch by microbatch"
    torch.cuda.synchronize()
    reset_launch_counts()
    y_seq, dx_seq, db_seq = sequential([x], [gy])
    torch.cuda.synchronize()
    seq_counts = {k_: c for k_, c in launch_counts().items() if c}
    assert seq_counts == {"gemm_4bit_paired": n_layers, "gemm_4bit_paired_nt": n_layers}, f"4o sequential {seq_counts}"
    seq_errs = {"out": rel_err(y, y_seq), "grad_x": rel_err(dx, dx_seq), "grad_bias": rel_err(db, db_seq)}
    assert all(e <= 5e-2 for e in seq_errs.values()), f"4o gpipe against one pass over all rows: {seq_errs}"
    assert torch.isfinite(y).all() and torch.isfinite(dx).all() and torch.isfinite(db).all()
    pipe_t = wall_and_device(pipelined)
    seq_t = wall_and_device(lambda: sequential([x], [gy]))
    emit("ring_and_pipeline", config="llama3_8b widths", backend="nccl",
         ring={"B": B, "T": T, "H": H, "kv_heads": KVH, "head_dim": hd, "dtype": "bfloat16", "causal": True,
               "max_abs_err_vs_oracle": errs, "timing": timing, "virtual_ranks_rel_err": virtual},
         gpipe={"layers": n_layers, "D": D, "blocksize": 64, "rows": rows, "microbatches": M, "stages": 1,
                "bit_equal_microbatch_sequence": True, "rel_err_vs_one_pass": seq_errs,
                "launches": pipe_counts, "launches_sequential": seq_counts,
                "pipelined": pipe_t, "sequential": seq_t,
                "max_abs_activation": y.float().abs().max().item()})
    del layers, stacked, x, gy, y, dx, db, y_mb, dx_mb, db_mb, y_seq, dx_seq, db_seq
    torch.cuda.empty_cache()
    return pipe_counts


def meshed_qlora(cfg, params, tids, ref, rank, alpha, chunk, steps=3):
    """4p: 4d's QLoRA step (the double-quantized model, rank 64 on seven
    targets, ``adamw8bit``, ids [4, 513], ``token_chunk`` 512) over a
    ``{"data": 1, "seq": 1, "model": 1}`` mesh on the one-rank NCCL group,
    ``steps`` steps: the ring runs the attention, the split linears their
    adjoints, the loss and the gradients their sums.  The first step's loss
    (rel 1e-3) and adapter gradients (rtol 2e-2 / atol 2e-3) against one
    meshless step from the same adapters, the launches of kernels 6 and 14
    a step equal to the meshless step's, the collectives a step, the step's
    wall (steps 2-3; the first sets up the groups' communicators) and the
    peak memory beside 4d's, and one more step of each, meshless then
    meshed, timed on the host and profiled for its device ms."""
    import torch

    from bitsandbytes_tpu_torch import optim as O
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.parallel import Sharded, llama_param_specs, make_mesh

    dev = tids.device
    one_rank_mesh()
    axes = {"data": 1, "seq": 1, "model": 1}
    mesh = make_mesh(axes)
    calls = counted_collectives(mesh)
    sparams = llama_param_specs(mesh, params)

    def adapters():
        lora = L.add_lora(cfg, rank=rank, alpha=alpha, targets=LORA_TARGETS,
                          generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        return lora, O.adamw8bit(L.lora_parameters(lora), 1e-3)

    lora_a, opt_a = adapters()
    torch.cuda.synchronize()
    reset_launch_counts()
    loss_a = L.lora_train_step(params, lora_a, opt_a, tids, cfg, token_chunk=chunk).item()
    counts_a = {k: v for k, v in launch_counts().items() if v}
    grads_a = [t.grad.clone() for t in L.lora_parameters(lora_a)]
    del lora_a, opt_a

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()  # as 4d counts it: the adapters and states included
    torch.cuda.reset_peak_memory_stats()
    lora_b, opt_b = adapters()
    reset_launch_counts()
    losses, walls, calls_1 = [], [], None
    for s in range(steps):
        calls.update(all_gather=0, all_reduce=0)
        t0 = time.perf_counter()
        losses.append(L.lora_train_step(sparams, lora_b, opt_b, tids, cfg, token_chunk=chunk, mesh=mesh).item())
        walls.append((time.perf_counter() - t0) * 1e3)
        if s == 0:
            calls_1 = dict(calls)
            grads_b = [t.grad.clone() for t in L.lora_parameters(lora_b)]
    counts_b = {k: v for k, v in launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() - base
    assert abs(losses[0] - loss_a) <= 1e-3 * abs(loss_a), f"4p loss {losses[0]} against meshless {loss_a}"
    worst = 0.0
    for a, b in zip(grads_b, grads_a):
        assert torch.allclose(a, b, rtol=2e-2, atol=2e-3), "4p adapter gradients against the meshless step's"
        worst = max(worst, (a - b).abs().max().item())
    assert counts_b == {k: v * steps for k, v in counts_a.items()}, f"4p launches {counts_b} != {steps} x {counts_a}"
    assert counts_a.get("dequantize_paired_fast_dq") and counts_a.get("optimizer_update_8bit") == 1, counts_a
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"4p losses {losses}"
    Lyr = cfg.num_layers
    n_split = sum(isinstance(layer[k], Sharded) for layer in sparams["layers"] for k in layer)
    chunks = -(-tids.shape[0] * (tids.shape[1] - 1) // chunk)
    # forward: a gather for each split linear and lm_head chunk, again when a chunk is recomputed, a sum for
    # the embedding and one for each batch axis of the loss; backward: a sum of grad_x for each split linear
    # and chunk; the gradients: one sum for each batch axis
    want = {"all_gather": n_split + 2 * chunks, "all_reduce": 1 + 2 + n_split + chunks + 2}
    assert calls_1 == want, f"4p collectives a step {calls_1} != {want}"
    assert n_split == 2 * Lyr, f"4p: {n_split} split linears"
    # one more step of each, profiled, in turn: meshless, meshed
    lora_a, opt_a = adapters()
    timed = {"meshless": wall_and_device(lambda: L.lora_train_step(params, lora_a, opt_a, tids, cfg,
                                                                   token_chunk=chunk).item(), n=1),
             "mesh": wall_and_device(lambda: L.lora_train_step(sparams, lora_b, opt_b, tids, cfg, token_chunk=chunk,
                                                               mesh=mesh).item(), n=1)}
    emit("meshed_qlora", config="llama3_8b", layers=Lyr, mesh=axes, backend="nccl", compress_statistics=True,
         lora_rank=rank, optimizer="adamw8bit", batch=tids.shape[0], seq=tids.shape[1] - 1, token_chunk=chunk,
         steps=steps, losses=losses, meshless_loss=loss_a, loss_rel_diff=abs(losses[0] - loss_a) / abs(loss_a),
         max_abs_grad_diff=worst, launches=counts_b, launches_meshless_step=counts_a, collectives_per_step=calls_1,
         step_wall_ms={"median_2_3": statistics.median(walls[1:]), "all": walls}, timed_steps=timed,
         peak_memory=peak, qlora_train_4d={"step_ms_median_2_5": ref["step_ms"]["median_2_5"],
                                           "peak_memory": ref["peak"]})
    del lora_a, opt_a, lora_b, opt_b, grads_a, grads_b, sparams
    torch.cuda.empty_cache()
    return counts_b


def slice20_cpu_check(dev):
    """5j: this slice's paths at small size, card against CPU, untimed:
    ring attention (rings of 2 and 4 computed rank by rank on f32 inputs,
    and the one-rank NCCL ring forward and backward) against the CPU's
    within 1e-4 relative; GPipe over 4 NF4 layers of D 256 (bf16 x [8, 256],
    4 microbatches: kernels 2 and 7) against the CPU's layers in sequence
    within 5's logits gate (atol 0.1 / rtol 0.05); one meshed
    ``lora_train_step`` of the tiny Llama at one rank against the CPU's
    meshless step (5b's gates: the loss of the bf16 model within rel 1e-3,
    the gradients of the f32 one within rtol 2e-2 / atol 2e-3)."""
    import torch
    import torch.nn.functional as F

    from bitsandbytes_tpu_torch import autograd
    from bitsandbytes_tpu_torch import optim as O
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.parallel import (
        gpipe,
        llama_param_specs,
        make_mesh,
        ring_attention,
        ring_attention_local,
        stack_stage_params,
    )

    t_start = time.perf_counter()
    one_rank_mesh()
    g = torch.Generator().manual_seed(40)
    B, T, H, d = 2, 32, 4, 64
    q, k, v = (torch.randn(B, T, H, d, generator=g) for _ in range(3))
    ring_err = {}
    for causal in (True, False):
        for n in (2, 4):
            Tl = T // n

            def parts(q, k, v):
                ks, vs = k.split(Tl, dim=1), v.split(Tl, dim=1)
                return torch.cat([ring_attention_local(q[:, r * Tl : (r + 1) * Tl],
                                                       [(ks[(r - i) % n], vs[(r - i) % n]) for i in range(n)],
                                                       r, n, causal) for r in range(n)], dim=1)

            c, gc = parts(q, k, v), parts(q.to(dev), k.to(dev), v.to(dev)).cpu()
            ring_err[f"{n}_ranks_{'causal' if causal else 'full'}"] = rel_err(gc, c)
            assert rel_err(gc, c) <= 1e-4, f"5j ring of {n} (causal {causal}) against the CPU"
    w = torch.randn(B, T, H, d, generator=g)
    mesh = make_mesh({"seq": 1})
    grads = {}
    for where in ("cpu", "card"):
        qs, ks_, vs_ = (t.clone().to(dev if where == "card" else "cpu").requires_grad_() for t in (q, k, v))
        if where == "card":
            out = ring_attention(qs, ks_, vs_, mesh)
        else:
            out = ring_attention_local(qs, [(ks_, vs_)], 0, 1)
        (out * w.to(out.device)).sum().backward()
        grads[where] = [t.cpu() for t in (out.detach(), qs.grad, ks_.grad, vs_.grad)]
    for key, a, b in zip(("out", "dq", "dk", "dv"), grads["card"], grads["cpu"]):
        ring_err[f"nccl_{key}"] = rel_err(a, b)
        assert rel_err(a, b) <= 1e-4, f"5j one-rank ring {key} against the CPU"

    # GPipe over 4 NF4 layers: the payloads quantized on the CPU and copied over
    D = 256
    layers = [{"w": QuantizedTensor.quantize(torch.randn(D, D, generator=g) * D**-0.5, blocksize=64)}
              for _ in range(4)]
    x = torch.randn(8, D, generator=g).to(torch.bfloat16)

    def layer_fn(p, a):
        h = autograd.matmul_4bit(a, p["w"].data, p["w"].state)
        return (a + F.gelu(h.to(torch.float32), approximate="tanh")).to(a.dtype)

    xc = x.clone().requires_grad_()
    yc = xc
    for p in layers:
        yc = layer_fn(p, yc)
    yc.float().pow(2).sum().backward()
    xg = x.to(dev).requires_grad_()
    reset_launch_counts()
    yg = gpipe(layer_fn, stack_stage_params(tree_to(layers, dev), 1), xg, make_mesh({"pipe": 1}), n_microbatches=4)
    yg.float().pow(2).sum().backward()
    torch.cuda.synchronize()
    pipe_counts = {k_: c for k_, c in launch_counts().items() if c}
    assert pipe_counts == {"gemm_4bit_paired": 32, "gemm_4bit_paired_nt": 16}, f"5j gpipe launches {pipe_counts}"
    assert torch.allclose(yg.float().cpu(), yc.float(), atol=0.1, rtol=0.05), "5j gpipe output against the CPU"
    assert torch.allclose(xg.grad.float().cpu(), xc.grad.float(), atol=0.1, rtol=0.05), "5j gpipe grad_x"
    pipe_err = {"out": (yg.float().cpu() - yc.float()).abs().max().item(),
                "grad_x_rel": rel_err(xg.grad.cpu(), xc.grad)}

    # one meshed QLoRA step of the tiny Llama at one rank against the CPU's meshless step: the loss on
    # the bf16 model, the gradients on the f32 one (in bf16 the ring's f32 probabilities and the dense
    # oracle's bf16 ones move the gradients past atol 2e-3, on the CPU alone too)
    import dataclasses

    tmesh = make_mesh({"data": 1, "seq": 1, "model": 1})
    ids = torch.randint(0, 512, (2, 9), generator=g)
    qlora = {"config": "tiny", "mesh": {"data": 1, "seq": 1, "model": 1}}
    for dt in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(L.LlamaConfig.tiny(), dtype=dt)
        cpu_p = L.quantize_params_4bit(L.init_params(cfg, torch.Generator().manual_seed(41), device="cpu"))
        lora0 = L.add_lora(cfg, rank=4, targets=LORA_TARGETS, generator=torch.Generator().manual_seed(42),
                           device="cpu")
        gb = torch.Generator().manual_seed(43)
        for layer in lora0["layers"]:  # b non-zero, so that every adapter tensor has a gradient
            for ad in layer.values():
                ad["b"] = (torch.randn(ad["b"].shape, generator=gb) * 0.02).requires_grad_()

        def fresh(device):
            return {"layers": [{n_: {k_: t.detach().clone().to(device).requires_grad_() for k_, t in ad.items()}
                                for n_, ad in layer.items()} for layer in lora0["layers"]]}

        lc = fresh("cpu")
        loss_c = L.lm_loss(cpu_p, lc, ids, cfg)
        loss_c.backward()
        lg = fresh(dev)
        opt = O.adamw8bit(L.lora_parameters(lg), 1e-3)
        reset_launch_counts()
        loss_g = L.lora_train_step(llama_param_specs(tmesh, tree_to(cpu_p, dev)), lg, opt, ids.to(dev), cfg,
                                   mesh=tmesh).item()
        torch.cuda.synchronize()
        step_counts = {k_: c for k_, c in launch_counts().items() if c}
        assert step_counts.get("gemm_4bit_paired") and step_counts.get("gemm_4bit_paired_nt"), step_counts
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        res = {"loss_card": loss_g, "loss_cpu": loss_c.item(), "launches": step_counts}
        if dt == torch.bfloat16:
            assert abs(loss_g - loss_c.item()) <= 1e-3 * abs(loss_c.item()), f"5j loss {loss_g} vs {loss_c.item()}"
        else:
            grad_err = 0.0
            for tg, tc in zip(L.lora_parameters(lg), L.lora_parameters(lc)):
                assert torch.allclose(tg.grad.cpu(), tc.grad, rtol=2e-2, atol=2e-3), \
                    "5j adapter gradients against the CPU"
                grad_err = max(grad_err, (tg.grad.cpu() - tc.grad).abs().max().item())
            res["max_abs_grad_diff"] = grad_err
        qlora[tag] = res
    emit("cpu_check_slice20", ring_rel_err=ring_err, gpipe={"layers": 4, "D": D, "max_abs_diff": pipe_err,
                                                            "launches": pipe_counts},
         qlora=qlora, seconds=time.perf_counter() - t_start)


def mistral_window(params, dev):
    """4q: Mistral-7B (``LlamaConfig.mistral_7b()``: Llama-3-8B's widths with
    ``rope_theta`` 1e4 and ``sliding_window`` 4096, mistralai/Mistral-7B-v0.1's
    ``config.json``) on 4b's double-quantized fused NF4 model: the two
    configurations share every shape, so seed 0 gives the same weights.

    (a) Serving: batch 2, 4608-token prompts (the window bites in the
    prefill and in every decode step), 16 greedy decode steps over a bf16
    cache of 4672 positions, meshless and then over ``{"data": 1, "seq": 1,
    "model": 1}`` at one NCCL rank: every logit bit for bit, the same
    tokens and launches (kernels 6, 4 and its combine, 5), the collectives
    counted; a 2-layer copy at virtual ``seq`` coordinates 0 and 1 of a
    ``{"seq": 2}`` mesh bit for bit the meshless copy; the prefill's and a
    decode step's device ms by kernel class, wall ms, resident bytes.
    (b) The windowed ring at Mistral's attention widths (B 1, T 8192, H 32
    over 8 KV heads, hd 128, bf16, window 4096): the one-rank NCCL ring and
    rings of 2 and 4 computed rank by rank, forward and backward, against
    the dense oracle (``models/llama._attention`` with the window) within
    4o's tolerances, the blocks whose einsums ran counted (in the ring of 4
    the pair q rank 3, k rank 0 lies outside the window); ms and peak memory
    of the one-rank ring, the oracle and SDPA with a boolean window mask.
    (c) One QLoRA step (4d's recipe: rank 64, alpha 16, seven targets,
    ``adamw8bit``, ``token_chunk`` 512) of a 2-layer copy at full widths,
    ids [1, 6145] (the window bites for the last 2048 positions), over the
    ``{"data": 1, "seq": 1, "model": 1}`` mesh (the windowed ring) against
    the meshless step (the dense oracle): the loss within rel 1e-3, the
    gradients against rtol 2e-2 / atol 2e-3 (recorded), launches, wall and
    peak memory."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from bitsandbytes_tpu_torch import optim as O
    from bitsandbytes_tpu_torch.functional import gemm as GM
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.ops import flash_cached as FC
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.parallel import (
        Sharded,
        llama_param_specs,
        make_mesh,
        ring_attention,
        ring_attention_local,
        shard_kv_cache,
    )

    # the module (the package exports its function under the same name)
    RA = importlib.import_module("bitsandbytes_tpu_torch.parallel.ring_attention")
    t_start = time.perf_counter()
    cfg = L.LlamaConfig.mistral_7b()
    assert cfg == dataclasses.replace(L.LlamaConfig.llama3_8b(), rope_theta=1e4, sliding_window=4096)
    W, H, KVH, hd, Lyr = cfg.sliding_window, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    G = H // KVH
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one_rank_mesh()
    axes = {"data": 1, "seq": 1, "model": 1}
    mesh = make_mesh(axes)
    calls = counted_collectives(mesh)
    gen = torch.Generator(device=dev).manual_seed(50)

    # -- (a) serving ------------------------------------------------------------
    B, T, steps = 2, 4608, 16
    max_len = T + 4 * steps
    assert T > W and B * T >= GM.LARGE_M_THRESHOLD, "the window must bite in the prefill, which takes the dequant route"
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev)

    def run(tree, m, cfg_, n_steps):
        """Prefill and ``n_steps`` greedy steps: logits, tokens, launches,
        wall ms of the prefill and of each step."""
        torch.cuda.synchronize()
        reset_launch_counts()
        calls.update(all_gather=0, all_reduce=0)
        cache = L.init_kv_cache(cfg_, B, max_len, device=dev)
        if m is not None:
            cache = shard_kv_cache(cache, m)
        t0 = time.perf_counter()
        logits, cache = L.prefill(tree, ids, cfg_, cache, mesh=m)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        walls = {"prefill_ms": (time.perf_counter() - t0) * 1e3, "step_ms": []}
        outs, toks = [logits], [tok]
        for s in range(n_steps):
            t0 = time.perf_counter()
            logits, cache = L.decode_step(tree, tok, cfg_, cache, T + s, mesh=m)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            walls["step_ms"].append((time.perf_counter() - t0) * 1e3)
            outs.append(logits)
            toks.append(tok)
        counts = {k: v for k, v in launch_counts().items() if v}
        return {"outs": outs, "toks": torch.stack(toks, 1), "counts": counts, "collectives": dict(calls),
                "walls": walls, "cache": cache}

    def combines(GT):
        return int(FC.flash_splits(B * KVH, GT, max_len, sms)[1] > 1)

    Tc = FC.GT_MAX // G
    chunks = [min(Tc, T - off) for off in range(0, T, Tc)]
    want = {"dequantize_paired_fast_dq": 4 * Lyr, "gemm_4bit_paired_dq": 4 * Lyr * steps,
            "flash_attention_cached": Lyr * (len(chunks) + steps),
            "flash_attention_combine": Lyr * (sum(combines(G * c) for c in chunks) + steps * combines(G))}
    want = {k: v for k, v in want.items() if v}
    sparams = llama_param_specs(mesh, params)
    runs = {}
    for tag, tree, m in (("meshless", params, None), ("mesh", sparams, mesh)):
        runs[tag] = run(tree, m, cfg, steps)
        if tag == "mesh":  # one prefill and one decode step more, profiled, on the cache the run filled
            cache = runs[tag].pop("cache")
            _, pf_ev, pf_wall = profiled(lambda: L.prefill(tree, ids, cfg, cache, mesh=m))
            tok = runs[tag]["toks"][:, -1]
            _, dc_ev, dc_wall = profiled(lambda: L.decode_step(tree, tok, cfg, cache, T + steps, mesh=m))
            del cache
        runs[tag].pop("cache", None)
        torch.cuda.empty_cache()
    a, b = runs["meshless"], runs["mesh"]
    assert a["counts"] == want, f"4q serve: launches {a['counts']} != {want}"
    assert b["counts"] == a["counts"], f"4q serve with mesh=: launches {b['counts']} != {a['counts']}"
    assert torch.equal(a["toks"], b["toks"]), "4q serve: greedy tokens with mesh= differ"
    assert all(bits_equal(x, y) for x, y in zip(a["outs"], b["outs"])), "4q serve: logits with mesh= differ"
    assert all(torch.isfinite(x).all() for x in a["outs"]) and a["outs"][0].shape == (B, T, cfg.vocab_size)
    want_calls = {"all_gather": (steps + 1) * (2 * Lyr + 1), "all_reduce": steps + 1}
    assert b["collectives"] == want_calls, f"4q collectives {b['collectives']} != {want_calls}"
    classes = [("dequantize_paired", "kernel 6 (dequantize_paired_fast_dq)"),
               ("gemm_4bit_paired", "kernel 5 (gemm_4bit_paired_dq)"),
               ("flash_combine", "split combine"), ("flash", "kernel 4 (flash_attention_cached)"),
               ("nccl", "NCCL collectives")]
    pf_us, dc_us = (sum(self_dev_us(e) for e in ev) for ev in (pf_ev, dc_ev))
    serving = {"batch": B, "prompt": T, "steps": steps, "max_len": max_len, "resident_bytes": tree_bytes(params),
               "launches": a["counts"], "collectives": b["collectives"],
               "wall_ms": {tag: {"prefill": r["walls"]["prefill_ms"],
                                 "step_median": statistics.median(r["walls"]["step_ms"][1:]),
                                 "step_range": [min(r["walls"]["step_ms"][1:]), max(r["walls"]["step_ms"][1:])]}
                           for tag, r in runs.items()},
               "prefill_profiled": {"device_ms": pf_us / 1e3, "wall_ms": pf_wall, "by_class": by_class(pf_ev, classes)},
               "decode_step_profiled": {"device_ms": dc_us / 1e3, "wall_ms": dc_wall,
                                        "by_class": by_class(dc_ev, classes)},
               "logits_bit_equal": True, "tokens": a["toks"][:, :8].tolist()}
    del runs, a, b, sparams
    torch.cuda.empty_cache()

    # the 2-layer copy at virtual seq coordinates: no collective runs on the cached path
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params2 = dict(params, layers=params["layers"][:2])
    ref2 = run(params2, None, cfg2, 4)
    virtual = {}
    for c in (0, 1):
        vm = make_mesh({"seq": 2}, coord=c)
        vtree = llama_param_specs(vm, params2)
        assert not any(isinstance(x, Sharded) for layer in vtree["layers"] for x in layer.values())
        got = run(vtree, vm, cfg2, 4)
        assert torch.equal(got["toks"], ref2["toks"]) and all(
            bits_equal(x, y) for x, y in zip(got["outs"], ref2["outs"])), f"4q: virtual seq coordinate {c}"
        assert got["counts"] == ref2["counts"], f"4q virtual seq {c}: {got['counts']} != {ref2['counts']}"
        virtual[f"seq_{c}"] = {"bit_equal": True, "launches": got["counts"]}
    del ref2, got
    torch.cuda.empty_cache()

    # -- (b) the windowed ring ------------------------------------------------------
    Tr = 8192
    q = torch.randn(1, Tr, H, hd, generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
    k, v = (torch.randn(1, Tr, KVH, hd, generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
            for _ in range(2))
    gout = torch.randn(1, Tr, H * hd, generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(Tr, device=dev)[None]
    valid = torch.ones(1, Tr, dtype=torch.bool, device=dev)
    smesh = make_mesh({"seq": 1})
    rep = lambda t: torch.repeat_interleave(t, G, dim=2)  # noqa: E731
    kp = torch.arange(Tr, device=dev)
    allowed = (kp[None, :] <= kp[:, None]) & (kp[None, :] > kp[:, None] - W)
    einsums = {"n": 0}
    block_attn = RA._block_attn

    def counted_block(*a_, **k_):
        einsums["n"] += 1
        return block_attn(*a_, **k_)

    def ring1(q, k, v):
        return ring_attention(q, rep(k), rep(v), smesh, axis="seq", window=W).reshape(1, Tr, H * hd)

    def ring_n(n):
        Tl = Tr // n

        def f(q, k, v):
            ks, vs = rep(k).split(Tl, dim=1), rep(v).split(Tl, dim=1)
            return torch.cat([ring_attention_local(q[:, r * Tl : (r + 1) * Tl],
                                                   [(ks[(r - i) % n], vs[(r - i) % n]) for i in range(n)], r, n,
                                                   window=W) for r in range(n)], dim=1).reshape(1, Tr, H * hd)
        return f

    def oracle(q, k, v):
        return L._attention(q, k, v, pos, valid, cfg)

    def sdpa(q, k, v):
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                           attn_mask=allowed, enable_gqa=True)
        return o.transpose(1, 2).reshape(1, Tr, H * hd)

    results, ring_blocks, timing = {}, {}, {}
    RA._block_attn = counted_block
    try:
        for name, f in (("oracle", oracle), ("ring_1", ring1), ("ring_2", ring_n(2)), ("ring_4", ring_n(4)),
                        ("sdpa", sdpa)):
            for t in (q, k, v):
                t.grad = None
            einsums["n"] = 0
            out = f(q, k, v)
            out.backward(gout)
            results[name] = [out.detach()] + [t.grad.clone() for t in (q, k, v)]
            ring_blocks[name] = einsums["n"]
            del out
            torch.cuda.empty_cache()
            if name in ("oracle", "ring_1", "sdpa"):
                timing[name] = events_fwd_bwd(f, (q, k, v), gout, n=3)
                torch.cuda.empty_cache()
    finally:
        RA._block_attn = block_attn
    # blocks with a visible (q, k) pair: causal alone would run 3 of 4 in the
    # ring of 2 and 10 of 16 in the ring of 4; the window drops (3, 0)
    assert ring_blocks["ring_1"] == 1 and ring_blocks["ring_2"] == 3 and ring_blocks["ring_4"] == 9, ring_blocks
    errs = {}
    for name in ("ring_1", "ring_2", "ring_4", "sdpa"):
        errs[name] = {"out_max_abs": (results[name][0].float() - results["oracle"][0].float()).abs().max().item(),
                      **{key: rel_err(x, y) for key, x, y in zip(("dq", "dk", "dv"), results[name][1:],
                                                                  results["oracle"][1:])}}
        assert all(math.isfinite(e) for e in errs[name].values()), f"4q {name}: {errs[name]}"
        if name != "sdpa":
            assert errs[name]["out_max_abs"] <= 2e-2, f"4q {name} output against the oracle: {errs[name]}"
            assert all(errs[name][key] <= 5e-2 for key in ("dq", "dk", "dv")), f"4q {name} gradients: {errs[name]}"
    ring = {"B": 1, "T": Tr, "H": H, "kv_heads": KVH, "head_dim": hd, "window": W, "dtype": "bfloat16",
            "block_einsums": ring_blocks, "err_vs_oracle": errs, "timing": timing}
    del results, q, k, v, gout, allowed
    torch.cuda.empty_cache()

    # -- (c) a QLoRA step over the mesh ---------------------------------------------
    rank, alpha, chunk, Tq = 64, 16.0, 512, 6144
    tids = torch.randint(0, cfg.vocab_size, (1, Tq + 1), generator=gen, device=dev)
    sparams2 = llama_param_specs(mesh, params2)

    def adapters():
        lora = L.add_lora(cfg2, rank=rank, alpha=alpha, targets=LORA_TARGETS,
                          generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        return lora, O.adamw8bit(L.lora_parameters(lora), 1e-3)

    steps_c = {}
    for tag, tree, m in (("meshless", params2, None), ("mesh", sparams2, mesh)):
        lora, opt = adapters()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = L.lora_train_step(tree, lora, opt, tids, cfg2, token_chunk=chunk, mesh=m).item()
        wall = (time.perf_counter() - t0) * 1e3
        steps_c[tag] = {"loss": loss, "wall_ms": wall, "peak_bytes": torch.cuda.max_memory_allocated() - base,
                        "launches": {k_: c for k_, c in launch_counts().items() if c},
                        "grads": [t.grad.clone() for t in L.lora_parameters(lora)]}
        del lora, opt
        torch.cuda.empty_cache()
    la, lb = steps_c["meshless"]["loss"], steps_c["mesh"]["loss"]
    assert math.isfinite(la) and abs(lb - la) <= 1e-3 * abs(la), f"4q step loss {lb} against meshless {la}"
    assert steps_c["mesh"]["launches"] == steps_c["meshless"]["launches"] == {
        "dequantize_paired_fast_dq": 8 * 2 - 1, "optimizer_update_8bit": 1}, steps_c
    ga, gb = steps_c["meshless"].pop("grads"), steps_c["mesh"].pop("grads")
    qlora = {"layers": 2, "batch": 1, "seq": Tq, "token_chunk": chunk, "lora_rank": rank, "steps": steps_c,
             "loss_rel_diff": abs(lb - la) / abs(la),
             "grads_within_rtol_2e-2_atol_2e-3": all(torch.allclose(x, y, rtol=2e-2, atol=2e-3) for x, y in zip(gb, ga)),
             "max_abs_grad_diff": max((x - y).abs().max().item() for x, y in zip(gb, ga)),
             "max_abs_grad": max(y.abs().max().item() for y in ga)}
    del ga, gb, sparams2, params2, tids
    torch.cuda.empty_cache()
    emit("mistral_window", config="mistral_7b", source="mistralai/Mistral-7B-v0.1 config.json",
         layers=Lyr, rope_theta=cfg.rope_theta, sliding_window=W, weights="nf4, nested, fused (4b's)",
         mesh=axes, backend="nccl", serving=serving, virtual_seq=virtual, ring=ring, qlora=qlora,
         seconds=time.perf_counter() - t_start)
    return serving["launches"]


def slice21_cpu_check(dev):
    """5k: this slice's paths at small size, card against CPU, untimed: the
    backward with f16 and f32 g on both sides of each dtype's threshold,
    both layouts, plain and nested (the route's kernel launched, the other
    not; f32 within 1e-5, f16 within 1e-2 relative of the CPU); the windowed
    ring, rings of 2 and 4 rank by rank at windows that mask none, part and
    all of a block, forward and backward within 1e-4 of the CPU; the tiny
    Llama with a sliding window of 12 served over the one-rank ``{"data":
    1, "seq": 1, "model": 1}`` mesh (prefill of 24 tokens and 4 steps,
    teacher-forced with the CPU's tokens) against the CPU's meshless run
    (5's gates: atol 0.1 / rtol 0.05, the CPU's token in the card's top 5),
    and its loss and gradients over the mesh (the windowed ring) against
    the CPU's meshless ones (the dense oracle; f32 model: loss rel 1e-3,
    gradients rtol 2e-2 / atol 2e-3)."""
    import dataclasses

    import torch

    from bitsandbytes_tpu_torch.functional import gemm as GM
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts
    from bitsandbytes_tpu_torch.parallel import llama_param_specs, make_mesh, ring_attention_local, shard_kv_cache

    t_start = time.perf_counter()
    g = torch.Generator().manual_seed(60)
    N, K = 256, 512
    W = torch.randn(N, K, generator=g) * K**-0.5
    routes = {}
    for layout, kw in (("paired", {"layout": "paired"}), ("2d", {"quant_storage": torch.bfloat16})):
        for nested in (False, True):
            qt = QuantizedTensor.quantize(W, blocksize=64, compress_statistics=nested, **kw)
            qg = tree_to({"w": qt}, dev)["w"]
            small_k = "gemm_4bit_paired_nt" if layout == "paired" else "gemm_4bit_nt_fused"
            large_k = "dequantize_paired_fast" if layout == "paired" else "dequantize_4bit_2d"
            if nested:
                large_k += "_dq"
                small_k += "_dq" if layout == "paired" else ""
            for dt in (torch.float16, torch.float32):
                th = GM.backward_threshold(dt, layout)
                for M in (th - 1, th):
                    gx = torch.randn(M, N, generator=g).to(dt)
                    ref = GM.gemm_4bit_grad_A(gx, qt.data, qt.state)
                    reset_launch_counts()
                    out = GM.gemm_4bit_grad_A(gx.to(dev), qg.data, qg.state)
                    torch.cuda.synchronize()
                    counts = {k_: c for k_, c in launch_counts().items() if c}
                    kernel, other = (small_k, large_k) if M < th else (large_k, small_k)
                    assert counts.get(kernel) == 1 and other not in counts, f"5k {layout} {dt} M {M}: {counts}"
                    err = rel_err(out.cpu(), ref)
                    assert out.dtype == dt and err <= (1e-5 if dt == torch.float32 else 1e-2), \
                        f"5k grad_A {layout} nested={nested} {dt} M {M}: rel {err}"
                    routes[f"{layout}{'_nested' if nested else ''}_{str(dt)[6:]}_M{M}"] = {"kernel": kernel,
                                                                                          "rel_err": err}

    # the windowed ring, rank by rank, card against CPU
    B, T, H, d = 2, 32, 4, 64
    ring = {}
    for n in (2, 4):
        Tl = T // n
        for window in (4, 12, 32):  # 4: the ring of 4's pair (q rank 2, k rank 0) lies outside; 32: no mask
            q, k, v = (torch.randn(B, T, H, d, generator=g) for _ in range(3))
            w = torch.randn(B, T, H, d, generator=g)
            res = {}
            for where in ("cpu", dev):
                qs, ks_, vs_ = (t.clone().to(where).requires_grad_() for t in (q, k, v))
                kb, vb = ks_.split(Tl, dim=1), vs_.split(Tl, dim=1)
                out = torch.cat([ring_attention_local(qs[:, r * Tl : (r + 1) * Tl],
                                                      [(kb[(r - i) % n], vb[(r - i) % n]) for i in range(n)], r, n,
                                                      window=window) for r in range(n)], dim=1)
                (out * w.to(where)).sum().backward()
                res[str(where)] = [t.detach().cpu() for t in (out, qs.grad, ks_.grad, vs_.grad)]
            errs = [rel_err(a, b) for a, b in zip(res[str(dev)], res["cpu"])]
            assert all(math.isfinite(e) and e <= 1e-4 for e in errs), f"5k ring of {n}, window {window}: {errs}"
            ring[f"{n}_ranks_window_{window}"] = max(errs)

    # the tiny Llama with a window, served over the one-rank mesh and trained over it
    one_rank_mesh()
    mesh = make_mesh({"data": 1, "seq": 1, "model": 1})
    cfg = dataclasses.replace(L.LlamaConfig.tiny(), sliding_window=12)
    cpu_p = L.quantize_params_4bit(L.init_params(cfg, torch.Generator().manual_seed(61), device="cpu"), fuse=True,
                                   compress_statistics=True)
    card_p = llama_param_specs(mesh, tree_to(cpu_p, dev))
    ids = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    cache_c = L.init_kv_cache(cfg, 2, 32, device="cpu")
    cache_g = shard_kv_cache(L.init_kv_cache(cfg, 2, 32, device=dev), mesh)
    lc, cache_c = L.prefill(cpu_p, ids, cfg, cache_c)
    lg, cache_g = L.prefill(card_p, ids.to(dev), cfg, cache_g, mesh=mesh)
    pairs = [(lg[:, -1].cpu(), lc[:, -1])]
    assert torch.allclose(lg.cpu(), lc, atol=0.1, rtol=0.05), "5k windowed prefill over the mesh against the CPU"
    tok = lc[:, -1].argmax(-1)
    for s in range(4):
        lc, cache_c = L.decode_step(cpu_p, tok, cfg, cache_c, 24 + s)
        lg, cache_g = L.decode_step(card_p, tok.to(dev), cfg, cache_g, 24 + s, mesh=mesh)
        pairs.append((lg.cpu(), lc))
        tok = lc.argmax(-1)
    serve_err = 0.0
    for a, b in pairs:
        assert torch.allclose(a, b, atol=0.1, rtol=0.05), "5k windowed decode over the mesh against the CPU"
        top5 = a.topk(5, dim=-1).indices
        assert (top5 == b.argmax(-1)[:, None]).any(-1).all(), "5k: the CPU's token outside the card's top 5"
        serve_err = max(serve_err, (a - b).abs().max().item())
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    cpu32 = L.quantize_params_4bit(L.init_params(cfg32, torch.Generator().manual_seed(61), device="cpu"))
    lora0 = L.add_lora(cfg32, rank=4, targets=LORA_TARGETS, generator=torch.Generator().manual_seed(62), device="cpu")
    gb = torch.Generator().manual_seed(63)
    for layer in lora0["layers"]:  # b non-zero, so that every adapter tensor has a gradient
        for ad in layer.values():
            ad["b"] = (torch.randn(ad["b"].shape, generator=gb) * 0.02).requires_grad_()
    tids = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    losses, grads = {}, {}
    for where in ("cpu", "card"):
        lora = {"layers": [{n_: {k_: t.detach().clone().to(dev if where == "card" else "cpu").requires_grad_()
                                 for k_, t in ad.items()} for n_, ad in layer.items()} for layer in lora0["layers"]]}
        if where == "card":
            loss = L.lm_loss(llama_param_specs(mesh, tree_to(cpu32, dev)), lora, tids.to(dev), cfg32, mesh=mesh)
        else:
            loss = L.lm_loss(cpu32, lora, tids, cfg32)
        loss.backward()
        losses[where] = loss.item()
        grads[where] = [t.grad.cpu() for t in L.lora_parameters(lora)]
    assert abs(losses["card"] - losses["cpu"]) <= 1e-3 * abs(losses["cpu"]), f"5k windowed loss {losses}"
    for a, b in zip(grads["card"], grads["cpu"]):
        assert torch.allclose(a, b, rtol=2e-2, atol=2e-3), "5k windowed adapter gradients against the CPU"
    emit("cpu_check_slice21", grad_A_routes=routes, windowed_ring_max_rel_err=ring,
         windowed_serve_max_abs_logit_diff=serve_err, windowed_loss=losses,
         max_abs_grad_diff=max((a - b).abs().max().item() for a, b in zip(grads["card"], grads["cpu"])),
         seconds=time.perf_counter() - t_start)


def flash_inputs(dev, gen, B, T, H, KVH, hd, dtype=None):
    """q, k, v and an output gradient (bf16 unless ``dtype`` says) for the
    causal flash kernels at one shape: q and k packed (the model's, after
    RoPE), v a view into a fused [B, T, (H + 2 KVH) hd] projection, as the
    model splits it."""
    import torch

    dt = dtype or torch.bfloat16
    q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(B, T, KVH, hd, generator=gen, device=dev).to(dt)
    qkv = torch.randn(B, T, (H + 2 * KVH) * hd, generator=gen, device=dev).to(dt)
    v = qkv[..., (H + KVH) * hd:].reshape(B, T, KVH, hd)
    do = torch.randn(B, T, H, hd, generator=gen, device=dev).to(dt)
    return q, k, v, do


def flash_causal_work(B, T, H, KVH, hd, elem=2):
    """(bytes, flops) of kernels 17, 18 and 19 at one shape, ``elem`` bytes
    an element of q, k, v, do and the outputs: every input read once and
    every output written once; the products over the causal half, T (T + 1)
    / 2 (query, key) pairs a head, 2 hd flops a pair and product: two
    products forward (q k^T, p v), four in dK/dV (q k^T, do v^T, p^T do, ds^T
    q), three in dQ (q k^T, do v^T, ds k)."""
    pairs = B * H * T * (T + 1) // 2
    qb, kvb, rows = B * T * H * hd * elem, B * T * KVH * hd * elem, B * H * T * 4
    return {"fwd": (2 * qb + 2 * kvb + 2 * rows, 2 * 2 * hd * pairs),
            "dkv": (2 * qb + 4 * kvb + 3 * rows, 4 * 2 * hd * pairs),
            "dq": (3 * qb + 2 * kvb + 3 * rows, 3 * 2 * hd * pairs)}


def dkv_combines(dev, B, T, H, KVH, hd):
    """1 where kernel 18's work plan on this card splits a key tile at this
    shape, so that its combine runs once a backward; else 0."""
    from bitsandbytes_tpu_torch.ops import flash_attention as FA

    return 1 if FA._dkv_tables(B, T, H, KVH, hd, dev)[0].combine else 0


def flash_train_kernels(dev, entry):
    """3p: kernels 17-19, the causal flash attention of the training path
    (``ops/flash_attention.py``), each against its plain version on the same
    inputs at Llama-3-8B's attention (B 1, H 32 over 8 KV heads, hd 128) at
    T 1024, 2048 (4r's), 4096 and 8192, and Gemma-7B's (H 16 over 16, hd
    256) at T 4096: the backward kernels take the plain forward's m and l and
    ``di = sum(o * do)``, so each kernel is held alone (the output within 2e-2
    abs, each gradient within 1e-2 of its largest magnitude; m within 1e-4
    abs and l within 1e-5 rel), each twice, bit for bit.  Device ms with
    the host held out and L2 flushed, median of 20, beside the plain
    versions and SDPA (``is_causal``, ``enable_gqa``) forward and backward
    on the same tensors, with each kernel's bytes, flops and bound.  Then the
    threshold sweep: at T 512 and 1024 (hd 128) the kernels' forward and
    backward through ``FlashAttentionCausal`` against the dense f32 oracle
    (``models/llama._attention``), events around each, and their peaks.  The
    kernels line takes T 2048.  Each kernel's bound share stands beside
    that of its earlier mma.sync body (``FLASH_FWD_MMA_SYNC_MS``,
    ``FLASH_DKV_MMA_SYNC_MS``, ``FLASH_DQ_MMA_SYNC_MS``), with kernel 18's
    work plan at each shape, and the SASS of each forward, dK/dV and dQ
    instance must hold ``HGMMA`` and ``UTMALDG`` and no ``STL`` (wgmma, TMA,
    no spills).  At T 1024, where the plan splits key tiles, kernel 18's
    combine on random partials under that plan is held bit for bit against
    its plain version and timed (its kernels-line entry).  Two batched shapes (B 2, T
    1152, hd 128; B 3, T 640, hd 256) hold each kernel to the same
    tolerances, untimed.  Each forward call of a timed shape must add one
    to the launch count of the kernel its route names (``FA.launch_name``):
    at hd 384 and 512 in bf16 and f16 the sliced wgmma instances of all
    three kernels (their own kernels-line entries, from the bf16 hd 512
    shape: the forward timed beside SDPA's forward, dK/dV and dQ beside
    SDPA's backward and the wide family's dK/dV and dQ, each called through
    its C entry on the same tensors and held to the type's gradient gate).  Batched GQA shapes at hd 384 and 512,
    whose plans split key tiles, take the sliced instances too, each dK/dV
    and dQ call twice bit for bit and the combine under that plan bit for
    bit its plain version; two at hd 640 (bf16, f16) take the wide family's
    16-bit instances, and two in f32 (B 2, H 4 over 2, hd 384; B 1, H 2 over
    1, hd 512; T 640) its f32 instances, through the route and its gates.  In f32 (T 2048: H 32 over 8 at hd 128, and Gemma-7B's
    H 16 over 16 at hd 256) the three kernels run their three-pass TF32
    instances (each its own kernels-line entry, both shapes beside it, bound
    by three TF32 passes at 495 TFLOP/s with the f32-FMA figure beside it;
    the forward within 1e-5 abs on o, its m and l as in every type, o, m and
    l twice bit for bit), each timed beside the wide family's kernel through
    its C entry on the same tensors (the wide entries' times), which is held
    to the same f32 gates (the forward's o, m and l; dk, dv and dq); the batched
    f32 shape, whose plan splits key tiles, runs each twice bit for bit and
    the dK/dV combine bit for bit; every ``HGMMA`` of their SASS is a TF32
    one, with ``UTMALDG`` and no ``STL``.  In bf16 and f16 at hd 640, 768
    and 1024 (B 1, T 2048, H 8 over 8) the forward runs its streamed
    instance (``..._fwd_streamed``: one launch a call, none of the wide
    forward; its own kernels-line entry from bf16 hd 640), timed beside
    SDPA's forward and the wide forward through its C entry on the same
    tensors, both held to the type's gates; dK/dV and dQ there, and all three
    kernels in f32 at hd 384 and 512 (the same B, T and heads), run the wide
    family through the route, timed beside SDPA's forward and backward (the
    wide entries of the kernels line take f32 hd 512, the others beside
    it); a batched bf16 shape at hd 1152 streams q's chunks too.  The SASS
    counts and the registers (``cuobjdump -res-usage``) of every instance
    are emitted."""
    import torch
    import torch.nn.functional as F

    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.ops import _lib
    from bitsandbytes_tpu_torch.ops import flash_attention as FA
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time

    gen = torch.Generator(device=dev).manual_seed(60)
    rel = lambda a, b: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()  # noqa: E731
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [(bf16, 1, T, 32, 8, 128) for T in (1024, 2048, 4096, 8192)] + [(bf16, 1, 4096, 16, 16, 256)]
    # f16 on the wgmma kernels, f32 on the TF32 instances, head_dim 384 / 512
    # on the sliced wgmma instances
    cases += [(f16, 1, T, 32, 8, 128) for T in (2048, 4096)] + [(f16, 1, 4096, 16, 16, 256), (f32, 1, 2048, 32, 8, 128)]
    cases += [(dt, 1, 2048, 8, 8, hd) for dt in (bf16, f16) for hd in (384, 512)]
    # f32 at Gemma-7B's attention: kernels 17-19's TF32 instances at head_dim 256
    cases += [(f32, 1, 2048, 16, 16, 256)]
    # the forward's streamed instance in bf16 and f16, and the wide family
    # where the route sends it: 16-bit dK/dV and dQ from head_dim 640, all
    # three in f32 at 384 and 512
    cases += [(dt, 1, 2048, 8, 8, hd) for dt in (bf16, f16) for hd in (640, 768, 1024)]
    cases += [(f32, 1, 2048, 8, 8, hd) for hd in (384, 512)]

    def flash_err(errs, key):  # a kernel's max_abs_err: o's abs error, or its gradients' relative one
        return errs["o_abs"] if key == "fwd" else max(errs[f"{g}_rel"] for g in
                                                       (("dk", "dv") if key == "dkv" else ("dq",)))

    def check(what, dt, errs):  # every error given (a kernel's own, or all six of a route) within its gate
        out_tol, grad_tol = FLASH_TOLERANCES[str(dt)[6:]]
        tol = {"o_abs": out_tol, "m_abs": 1e-4, "l_rel": 1e-5, "dq_rel": grad_tol, "dk_rel": grad_tol,
               "dv_rel": grad_tol}
        assert errs and all(math.isfinite(e) and e <= tol[n] for n, e in errs.items()), f"{what}: {errs}"

    def dev_ms(fn):
        return cuda_time(fn, n=20, flush_l2=True, hold=True)["median"]

    def plain_ms(fn):
        return cuda_time(fn, n=3, warmup=1)["median"]

    def dkv_wide(*bwd):
        """Kernel 18's wide-family instance through its C entry, which the
        route no longer takes for 16-bit q, k, v at head_dim 384 and 512 nor
        for f32 at 128 and 256: the same plan and combine as the wrapper's."""
        (B, T, H, KVH, hd), ptrs, strides = FA._bwd_args(*bwd)
        plan, items, table = FA._dkv_tables(B, T, H, KVH, hd, dev)
        dk = torch.empty(B, T, KVH, hd, dtype=bwd[0].dtype, device=dev)
        dv = torch.empty_like(dk)
        parts = [torch.empty(plan.slots, FA.DKV_KEYS, FA.DKV_COLS, device=dev) for _ in range(2)] if plan.slots else []
        err = _lib.lib().bnb_flash_attention_causal_bwd_dkv_wide(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *([t.data_ptr() for t in parts] or [None, None]), items.data_ptr(),
            len(plan.items), B, T, H, KVH, hd, *strides, hd**-0.5, FA._KIND[dk.dtype], _lib.stream(dk))
        _lib.check(err, "flash_attention_causal_bwd_dkv_wide")
        if parts:
            FA.flash_attention_causal_bwd_dkv_combine(*parts, table, dk, dv)
        return dk, dv

    def fwd_wide(q, k, v):
        """Kernel 17's wide-family instance through its C entry, which the
        route no longer takes for f32 q, k, v at head_dim 128 and 256."""
        B, T, H, hd = q.shape
        o_ = torch.empty_like(q)
        m_, l_ = (torch.empty(B, H, T, device=dev) for _ in range(2))
        err = _lib.lib().bnb_flash_attention_causal_fwd_wide(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o_.data_ptr(), m_.data_ptr(), l_.data_ptr(), B, T, H,
            k.shape[2], hd, *FA._strides("q", q), *FA._strides("k", k), *FA._strides("v", v), hd**-0.5,
            FA._KIND[q.dtype], _lib.stream(q))
        _lib.check(err, "flash_attention_causal_fwd_wide")
        return o_, m_, l_

    def dq_wide(*bwd):
        """Kernel 19's wide-family instance through its C entry, which the
        route no longer takes for 16-bit q, k, v at head_dim 384 and 512."""
        (B, T, H, KVH, hd), ptrs, strides = FA._bwd_args(*bwd)
        dq = torch.empty(B, T, H, hd, dtype=bwd[0].dtype, device=dev)
        err = _lib.lib().bnb_flash_attention_causal_bwd_dq_wide(
            *ptrs, dq.data_ptr(), B, T, H, KVH, hd, *strides, hd**-0.5, FA._KIND[dq.dtype], _lib.stream(dq))
        _lib.check(err, "flash_attention_causal_bwd_dq_wide")
        return dq

    def combine_against_plain(what, plan, plan_table, dk, dv, seed):
        """Kernel 18's combine under ``plan`` on random partials of its
        shape, bit for bit its plain version: (part_k, part_v, the kernel's
        dk and dv, the plain version's)."""
        assert plan.combine, f"{what}: kernel 18's plan splits no key tile"
        gen_c = torch.Generator(device=dev).manual_seed(seed)
        part_k, part_v = (torch.randn(plan.slots, FA.DKV_KEYS, FA.DKV_COLS, generator=gen_c, device=dev)
                          for _ in range(2))
        ck = FA.flash_attention_causal_bwd_dkv_combine(part_k, part_v, plan_table, torch.zeros_like(dk),
                                                       torch.zeros_like(dv))
        cp = FA.flash_attention_causal_bwd_dkv_combine_plain(part_k, part_v, plan_table, torch.zeros_like(dk),
                                                             torch.zeros_like(dv))
        assert all(torch.equal(a, b) for a, b in zip(ck, cp)), f"{what}: the dK/dV combine differs from its plain"
        return part_k, part_v, ck, cp

    out, wide_rows = [], []
    for dt, B, T, H, KVH, hd in cases:
        q, k, v, do = flash_inputs(dev, gen, B, T, H, KVH, hd, dt)
        family = dict(zip(FLASH_KERNELS, flash_names(dt, hd)))
        _lib.reset_launch_counts()
        o, m, l = FA.flash_attention_causal_fwd(q, k, v)
        assert {n: c for n, c in _lib.launch_counts().items() if c} == {family["fwd"]: 1}, \
            f"3p {dt} hd {hd}: {_lib.launch_counts()}"
        op, mp, lp = FA.flash_attention_causal_fwd_plain(q, k, v)
        di = (op.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, mp, lp, di)
        dk, dv = FA.flash_attention_causal_bwd_dkv(*bwd)
        dq = FA.flash_attention_causal_bwd_dq(*bwd)
        dkp, dvp = FA.flash_attention_causal_bwd_dkv_plain(*bwd)
        dqp = FA.flash_attention_causal_bwd_dq_plain(*bwd)
        what = f"3p {str(dt)[6:]} B{B} T{T} H{H} KVH{KVH} hd{hd}"
        errs = {"o_abs": (o.float() - op.float()).abs().max().item(), "m_abs": (m - mp).abs().max().item(),
                "l_rel": rel(l, lp), "dq_rel": rel(dq, dqp), "dk_rel": rel(dk, dkp), "dv_rel": rel(dv, dvp)}
        check(what, dt, errs)
        again = (*FA.flash_attention_causal_fwd(q, k, v), *FA.flash_attention_causal_bwd_dkv(*bwd),
                 FA.flash_attention_causal_bwd_dq(*bwd))
        assert all(torch.equal(a, b) for a, b in zip(again, (o, m, l, dk, dv, dq))), f"{what}: differs from run to run"
        del again

        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2)
        try:
            so = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            sdpa = {"fwd_ms": dev_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                             enable_gqa=True)),
                    "bwd_ms": dev_ms(lambda: torch.autograd.grad(so, (qt, kt, vt), dot, retain_graph=True)),
                    "out_abs_err_vs_kernel": (so.detach().transpose(1, 2).float() - o.float()).abs().max().item()}
            del so
        except RuntimeError as e:  # no SDPA backend takes this shape and type
            sdpa = {"fwd_ms": None, "bwd_ms": None, "error": str(e)[:200]}
        del qt, kt, vt
        work = flash_causal_work(B, T, H, KVH, hd, q.element_size())
        row = {"dtype": str(dt)[6:], "family": family, "B": B, "T": T, "H": H, "KVH": KVH, "hd": hd, "errs": errs,
               "sdpa": sdpa,
               "fwd": {"ms": dev_ms(lambda: FA.flash_attention_causal_fwd(q, k, v)),
                       "plain_ms": plain_ms(lambda: FA.flash_attention_causal_fwd_plain(q, k, v))},
               "dkv": {"ms": dev_ms(lambda: FA.flash_attention_causal_bwd_dkv(*bwd)),
                       "plain_ms": plain_ms(lambda: FA.flash_attention_causal_bwd_dkv_plain(*bwd))},
               "dq": {"ms": dev_ms(lambda: FA.flash_attention_causal_bwd_dq(*bwd)),
                      "plain_ms": plain_ms(lambda: FA.flash_attention_causal_bwd_dq_plain(*bwd))}}
        peak = PEAK_F32_FLOPS if dt == f32 else PEAK_BF16_FLOPS
        for key, (nb, ops) in work.items():
            if FA.uses_tf32(key, dt, hd):  # three TF32 passes a product
                b_ms, b_by = bound_ms(nb, 3 * ops, PEAK_TF32_FLOPS)
            else:
                b_ms, b_by = bound_ms(nb, ops, peak)
            row[key].update(bytes=nb, flops=ops, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / row[key]["ms"])
            if dt == f32:  # both yardsticks of an f32 kernel: f32 FMA, and three TF32 passes
                row[key].update(f32_fma_bound_ms=bound_ms(nb, ops, PEAK_F32_FLOPS)[0],
                                tf32x3_bound_ms=bound_ms(nb, 3 * ops, PEAK_TF32_FLOPS)[0])
        if FA.uses_tf32("fwd", dt, hd) or family["fwd"].endswith("_streamed"):
            # kernel 17's wide instance, which took these shapes before, on the same tensors
            wo, wm, wl = fwd_wide(q, k, v)
            wide_errs = {"o_abs": (wo - op).abs().max().item(), "m_abs": (wm - mp).abs().max().item(),
                         "l_rel": rel(wl, lp)}
            check(f"{what} wide forward", dt, wide_errs)
            row["fwd"]["wide_ms"] = dev_ms(lambda: fwd_wide(q, k, v))
            row["fwd"]["wide_bound_share"] = row["fwd"]["bound_ms"] / row["fwd"]["wide_ms"]
            row["fwd"].update(wide_err=wide_errs["o_abs"], wide_errs=wide_errs)
            del wo, wm, wl
        if not family["dkv"].endswith("_wide") and (hd > 256 or FA.uses_tf32("dkv", dt, hd)):
            # kernel 18's wide instance, which took these shapes before, on the same tensors
            wk, wv = dkv_wide(*bwd)
            wide_errs = {"dk_rel": rel(wk, dkp), "dv_rel": rel(wv, dvp)}
            check(f"{what} wide dK/dV", dt, wide_errs)
            row["dkv"]["wide_ms"] = dev_ms(lambda: dkv_wide(*bwd))
            row["dkv"]["wide_bound_share"] = row["dkv"]["bound_ms"] / row["dkv"]["wide_ms"]
            row["dkv"]["wide_err"] = max(wide_errs.values())
            del wk, wv
        if not family["dq"].endswith("_wide") and (hd > 256 or FA.uses_tf32("dq", dt, hd)):  # and kernel 19's
            wq = dq_wide(*bwd)
            row["dq"]["wide_err"] = rel(wq, dqp)
            check(f"{what} wide dQ", dt, {"dq_rel": row["dq"]["wide_err"]})
            row["dq"]["wide_ms"] = dev_ms(lambda: dq_wide(*bwd))
            row["dq"]["wide_bound_share"] = row["dq"]["bound_ms"] / row["dq"]["wide_ms"]
            del wq
        if dt == bf16:
            for key, table in (("fwd", FLASH_FWD_MMA_SYNC_MS), ("dkv", FLASH_DKV_MMA_SYNC_MS),
                               ("dq", FLASH_DQ_MMA_SYNC_MS)):
                old_ms = table.get((T, hd))
                if old_ms is not None:
                    row[key].update(mma_sync_ms=old_ms, mma_sync_bound_share=row[key]["bound_ms"] / old_ms,
                                    speedup_over_mma_sync=old_ms / row[key]["ms"])
        plan, _, plan_table = FA._dkv_tables(B, T, H, KVH, hd, dev)
        row["dkv"]["plan"] = {"items": len(plan.items), "split_key_tiles": len(plan.combine),
                              "partial_slots": plan.slots, "target_iterations": plan.target}
        if (dt, T, hd) == (bf16, 1024, 128):
            # kernel 18's combine under this plan, on partials of its shape
            part_k, part_v, ck, cp = combine_against_plain(what, plan, plan_table, dk, dv, 62)
            units = len(plan.combine)
            comb_bytes = 2 * plan.slots * FA.DKV_KEYS * FA.DKV_COLS * 4 + 2 * units * FA.DKV_KEYS * FA.DKV_COLS * 2
            comb_ops = 2 * (plan.slots - units) * FA.DKV_KEYS * FA.DKV_COLS
            entry("flash_attention_causal_bwd_dkv_combine",
                  dev_ms(lambda: FA.flash_attention_causal_bwd_dkv_combine(part_k, part_v, plan_table, ck[0], ck[1])),
                  plain_ms(lambda: FA.flash_attention_causal_bwd_dkv_combine_plain(part_k, part_v, plan_table,
                                                                                   cp[0], cp[1])),
                  None, comb_bytes, comb_ops, PEAK_F32_FLOPS, 0.0, shape=[B, T, H, KVH, hd],
                  split_key_tiles=units, partial_slots=plan.slots,
                  note="kernel 18's combine under its plan at 3p's T 1024 (the split key tiles' f32 partials "
                       "added in piece order, rounded once), on random partials; device ms, host held out, L2 "
                       "flushed; bit for bit its plain version; library_ms null: no single PyTorch call "
                       "computes it")
            del part_k, part_v, ck, cp
        row["bwd_ms"] = row["dkv"]["ms"] + row["dq"]["ms"]
        del op, mp, lp, dkp, dvp, dqp
        out.append(row)
        if dt != f32 and hd in (384, 512):  # the sliced instances of the three kernels
            wide_rows.append({"dtype": row["dtype"], "shape": [B, T, H, KVH, hd], "sdpa": sdpa, "errs": errs,
                              **{key: row[key] for key in ("fwd", "dkv", "dq")}})
        if FA.uses_tf32("fwd", dt, hd):  # kernels 17-19's TF32 instances at each of their shapes, entered below
            for key in FLASH_KERNELS:
                wide_rows.append({"tf32": key, "dtype": row["dtype"], "shape": [B, T, H, KVH, hd], "errs": errs,
                                  "sdpa_fwd_ms": sdpa["fwd_ms"], "sdpa_bwd_ms": sdpa["bwd_ms"],
                                  "kernels_bwd_ms": row["bwd_ms"], **row[key]})
        if (T, hd) == (2048, 128) and dt != f32:  # f32's TF32 and wide entries follow the loop
            for key, lib in (("fwd", sdpa["fwd_ms"]), ("dkv", None), ("dq", None)):
                nb, ops = work[key]
                extra = dict(shape=[B, T, H, KVH, hd], dtype=row["dtype"], family=family, sdpa_bwd_ms=sdpa["bwd_ms"],
                             kernels_bwd_ms=row["bwd_ms"])
                entry(family[key] + ("_f16" if dt == f16 else ""), row[key]["ms"], row[key]["plain_ms"], lib, nb,
                      ops, peak, flash_err(errs, key), **extra,
                      note="4r's attention shape; device ms, host held out, L2 flushed; the backward rows' "
                           "library_ms is null: SDPA's backward is one call for dq, dk and dv (sdpa_bwd_ms, "
                           "against kernels_bwd_ms, 18 + 19)" + (
                               "; max_abs_err is the output's abs error" if key == "fwd" else
                               "; max_abs_err is relative to the gradient's largest magnitude"))
        del q, k, v, do, o, m, l, di, dk, dv, dq, bwd
        torch.cuda.empty_cache()
    # the sliced instances' entries: bf16 and f16 at head_dim 384 and 512
    instances = [r for r in wide_rows if not r.get("tf32")]

    def inst(r, key):
        return {"dtype": r["dtype"], "shape": r["shape"], **r[key], "sdpa_fwd_ms": r["sdpa"]["fwd_ms"],
                "sdpa_bwd_ms": r["sdpa"]["bwd_ms"]}

    # kernels 17-19's TF32 instances: f32 at 4r's shape (hd 128) in the line, Gemma-7B's hd 256 beside it
    tf32_notes = {
        "fwd": "kernel 17's f32 instance at head_dim 128 and 256: a block 64 query rows of one head and all of hd, "
               "two consumer warpgroups and a producer warp; S = Q K^T and the online softmax (group 0) as three "
               "TF32 passes on wgmma with K split in the ring, then O^T += V^T P^T over half of hd's m tiles a "
               "group with P through a [row][key] tile pair and V^T split from V's raw columns, each key tile's "
               "product in a fresh accumulator added in f32; "
               "device ms, host held out, L2 flushed; bound_ms is three TF32 passes at 495 TFLOP/s "
               "(f32_fma_bound_ms: the same flops at 67); wide_ms the wide family's forward on the same tensors; "
               "library_ms is SDPA is_causal's f32 forward; max_abs_err is the output's abs error",
        "dkv": "kernel 18's f32 instance at head_dim 128 and 256: a block one item of the plan, every product as "
               "three TF32 passes (big * big + big * small + small * big) on wgmma, S^T and dP^T by two consumer "
               "warpgroups, then dV^T = dO^T P and dK^T = Q^T dS with P and dS through shared memory; device ms, "
               "host held out, L2 flushed; bound_ms is three TF32 passes at 495 TFLOP/s (f32_fma_bound_ms: the "
               "same flops at 67); wide_ms the wide family's dK/dV on the same tensors; library_ms is null: SDPA's "
               "backward is one call for dq, dk and dv (sdpa_bwd_ms, against kernels_bwd_ms, 18 + 19); "
               "max_abs_err is relative to the gradient's largest magnitude",
        "dq": "kernel 19's f32 instance at head_dim 128 and 256: a block 64 query rows of one head and all of hd, "
              "two consumer warpgroups and a producer warp; S = Q K^T (group 0) and dP = dO V^T (group 1) as three "
              "TF32 passes on wgmma with K and V split in the ring, then dQ^T = K^T dS^T over each group's half "
              "of hd with dS through a [row][key] tile pair and K^T split from its raw columns, each key tile's "
              "product in a fresh accumulator added in f32; device ms, host held out, L2 flushed; bound_ms is "
              "three TF32 passes at 495 TFLOP/s (f32_fma_bound_ms: the same flops at 67); wide_ms the wide "
              "family's dQ on the same tensors; library_ms is null: SDPA's backward is one call for dq, dk and dv "
              "(sdpa_bwd_ms, against kernels_bwd_ms, 18 + 19); max_abs_err is relative to dq's largest "
              "magnitude"}
    for key, name in zip(FLASH_KERNELS, FLASH_TF32):
        tf32 = [r for r in wide_rows if r.get("tf32") == key]
        main32 = next(r for r in tf32 if r["shape"][4] == 128)
        nb, ops = flash_causal_work(*main32["shape"], 4)[key]
        entry(name, main32["ms"], main32["plain_ms"], main32["sdpa_fwd_ms"] if key == "fwd" else None, nb, 3 * ops,
              PEAK_TF32_FLOPS, flash_err(main32["errs"], key), shape=main32["shape"], dtype="float32",
              f32_fma_bound_ms=main32["f32_fma_bound_ms"], wide_ms=main32["wide_ms"],
              sdpa_bwd_ms=main32["sdpa_bwd_ms"], kernels_bwd_ms=main32["kernels_bwd_ms"],
              instances=[{k: v for k, v in r.items() if k != "tf32"} for r in tf32], note=tf32_notes[key])
    # the forward's column-sliced wgmma instances: bf16 at hd 512 in the line, all four beside it
    main = next(r for r in instances if (r["dtype"], r["shape"][4]) == ("bfloat16", 512))
    nb, ops = flash_causal_work(*main["shape"])["fwd"]
    entry("flash_attention_causal_fwd_sliced", main["fwd"]["ms"], main["fwd"]["plain_ms"], main["sdpa"]["fwd_ms"],
          nb, ops, PEAK_BF16_FLOPS, main["errs"]["o_abs"], shape=main["shape"], dtype="bfloat16",
          instances=[inst(r, "fwd") for r in instances],
          note="kernel 17's bf16 / f16 instances at head_dim 384 and 512: a block 64 query rows of one head and "
               "half of o's columns, S over all of hd on wgmma; device ms, host held out, L2 flushed; "
               "library_ms is SDPA is_causal's forward; max_abs_err is the output's abs error")
    # dK/dV's sliced wgmma instances: bf16 at hd 512 in the line, all four beside it
    nb, ops = flash_causal_work(*main["shape"])["dkv"]
    entry("flash_attention_causal_bwd_dkv_sliced", main["dkv"]["ms"], main["dkv"]["plain_ms"], None, nb, ops,
          PEAK_BF16_FLOPS, max(main["errs"]["dk_rel"], main["errs"]["dv_rel"]), shape=main["shape"], dtype="bfloat16",
          instances=[inst(r, "dkv") for r in instances], wide_ms=main["dkv"]["wide_ms"],
          sdpa_bwd_ms=main["sdpa"]["bwd_ms"], kernels_bwd_ms=main["dkv"]["ms"] + main["dq"]["ms"],
          note="kernel 18's bf16 / f16 instances at head_dim 384 and 512: a block one item of the plan (64 keys, "
               "128 columns of dK/dV), q and do in its columns in a stage and the rest of hd streamed in 64-column "
               "chunks into S^T and dP^T on wgmma; device ms, host held out, L2 flushed; wide_ms is the wide "
               "family's dK/dV, which took these shapes before, on the same tensors; library_ms is null: SDPA's "
               "backward is one call for dq, dk and dv (sdpa_bwd_ms, against kernels_bwd_ms, 18 + 19); "
               "max_abs_err is relative to the gradient's largest magnitude")
    # dQ's sliced wgmma instances: bf16 at hd 512 in the line, all four beside it
    nb, ops = flash_causal_work(*main["shape"])["dq"]
    entry("flash_attention_causal_bwd_dq_sliced", main["dq"]["ms"], main["dq"]["plain_ms"], None, nb, ops,
          PEAK_BF16_FLOPS, main["errs"]["dq_rel"], shape=main["shape"], dtype="bfloat16",
          instances=[inst(r, "dq") for r in instances], wide_ms=main["dq"]["wide_ms"],
          sdpa_bwd_ms=main["sdpa"]["bwd_ms"], kernels_bwd_ms=main["dkv"]["ms"] + main["dq"]["ms"],
          note="kernel 19's bf16 / f16 instances at head_dim 384 and 512: a block 64 query rows of one head and "
               "half of dq's columns, a stage the K tile's slice, K's other 64-column chunks and V's streamed "
               "into S and dP on wgmma over all of hd; device ms, host held out, L2 flushed; wide_ms is the "
               "wide family's dQ, which took these shapes before, on the same tensors; library_ms is null: "
               "SDPA's backward is one call for dq, dk and dv (sdpa_bwd_ms, against kernels_bwd_ms, 18 + 19); "
               "max_abs_err is relative to the gradient's largest magnitude")

    # the forward's streamed instance: bf16 at hd 640 in the line, bf16 and
    # f16 at 640, 768 and 1024 beside it, each with the wide forward's time
    # and SDPA's on the same tensors
    def shape_of(r):
        return [r["B"], r["T"], r["H"], r["KVH"], r["hd"]]

    def beside(r, key, **more):
        return {"dtype": r["dtype"], "shape": shape_of(r), **r[key], "errs": r["errs"],
                "sdpa_fwd_ms": r["sdpa"]["fwd_ms"], "sdpa_bwd_ms": r["sdpa"]["bwd_ms"], **more}

    streamed = [r for r in out if r["family"]["fwd"].endswith("_streamed")]
    main_s = next(r for r in streamed if (r["dtype"], r["hd"]) == ("bfloat16", 640))
    nb, ops = flash_causal_work(*shape_of(main_s))["fwd"]
    entry("flash_attention_causal_fwd_streamed", main_s["fwd"]["ms"], main_s["fwd"]["plain_ms"],
          main_s["sdpa"]["fwd_ms"], nb, ops, PEAK_BF16_FLOPS, main_s["errs"]["o_abs"], shape=shape_of(main_s),
          dtype="bfloat16", wide_ms=main_s["fwd"]["wide_ms"],
          instances=[beside(r, "fwd", over_wide=r["fwd"]["wide_ms"] / r["fwd"]["ms"],
                            over_sdpa=r["sdpa"]["fwd_ms"] / r["fwd"]["ms"] if r["sdpa"]["fwd_ms"] else None)
                     for r in streamed],
          note="kernel 17's bf16 / f16 instance from head_dim 640: a block 64 query rows of one head and at most 256 "
               "of o's columns, S = Q K^T on wgmma over all of hd from 64-column chunks of K streamed through a "
               "ring (Q resident up to hd 1024), O += P V on wgmma over the block's V slice; device ms, host held "
               "out, L2 flushed; wide_ms is the wide family's forward, which took these shapes before, on the same "
               "tensors; library_ms is SDPA is_causal's forward; max_abs_err is the output's abs error")
    # the wide family where the route sends it: f32 at hd 512 in the line
    # (its launches come from 5l's f32 step there), f32 at 384 and the 16-bit
    # dK/dV and dQ from 640 beside it (and the 16-bit forward there through
    # its C entry, which the route no longer takes); hd128_ms is its time
    # through its C entry on the TF32 row's tensors (4r's attention shape)
    wide32 = {r["hd"]: r for r in out if r["dtype"] == "float32" and r["hd"] in (384, 512)}
    at128 = next(r for r in out if r["dtype"] == "float32" and (r["T"], r["hd"], r["H"]) == (2048, 128, 32))
    for key in FLASH_KERNELS:
        main_w = wide32[512]
        nb, ops = flash_causal_work(*shape_of(main_w), 4)[key]
        others = [beside(wide32[384], key)] + [
            beside(r, key) if key != "fwd" else
            {"dtype": r["dtype"], "shape": shape_of(r), "ms": r["fwd"]["wide_ms"], "bound_ms": r["fwd"]["bound_ms"],
             "bound_share": r["fwd"]["wide_bound_share"], "errs": r["fwd"]["wide_errs"],
             "sdpa_fwd_ms": r["sdpa"]["fwd_ms"], "through": "its C entry"} for r in streamed]
        entry(FA._BASE_NAMES[key] + "_wide", main_w[key]["ms"], main_w[key]["plain_ms"],
              main_w["sdpa"]["fwd_ms"] if key == "fwd" else None, nb, ops, PEAK_F32_FLOPS,
              flash_err(main_w["errs"], key), shape=shape_of(main_w), dtype="float32",
              tf32x3_bound_ms=main_w[key]["tf32x3_bound_ms"], sdpa_bwd_ms=main_w["sdpa"]["bwd_ms"],
              kernels_bwd_ms=main_w["bwd_ms"], hd128_ms=at128[key]["wide_ms"], instances=others,
              note="the wide family (CUDA cores, f32 FMA) where the route sends it: f32 at head_dim 384 and up, "
                   "bf16 / f16 dK/dV and dQ from 640; device ms, host held out, L2 flushed; bound_ms is the f32 "
                   "FMA rate (67 TFLOP/s; the 16-bit instances' bounds at 989); launches from 5l's f32 step at "
                   "head_dim 512; " + (
                       "library_ms is SDPA is_causal's f32 forward; max_abs_err is the output's abs error"
                       if key == "fwd" else
                       "library_ms is null: SDPA's backward is one call for dq, dk and dv (sdpa_bwd_ms); "
                       "max_abs_err is relative to the gradient's largest magnitude"))

    # more than one sequence and T off a power of two: each kernel against its
    # plain version at 3p's tolerances, untimed (inputs from a generator of
    # their own); each plan splits key tiles, so the combine runs in each type
    batched, gen_b = [], torch.Generator(device=dev).manual_seed(61)
    for dt, B, T, H, KVH, hd in ((bf16, 2, 1152, 8, 2, 128), (bf16, 3, 640, 2, 1, 256), (f16, 3, 640, 2, 1, 256),
                                 (f32, 2, 1152, 8, 2, 128), (bf16, 2, 640, 4, 2, 384), (f16, 2, 640, 4, 2, 512),
                                 (bf16, 1, 640, 2, 1, 640), (f16, 1, 640, 2, 1, 640), (f32, 2, 640, 4, 2, 384),
                                 (f32, 1, 640, 2, 1, 512), (bf16, 2, 640, 4, 2, 1152)):
        q, k, v, do = flash_inputs(dev, gen_b, B, T, H, KVH, hd, dt)
        what = f"3p batched {str(dt)[6:]} B{B} T{T} H{H} KVH{KVH} hd{hd}"
        _lib.reset_launch_counts()
        o, m, l = FA.flash_attention_causal_fwd(q, k, v)
        assert _lib.launch_counts()[flash_names(dt, hd)[0]] == 1, what
        if FA.uses_tf32("fwd", dt, hd) or hd >= 640:  # kernel 17's TF32 and streamed instances on batches
            again = FA.flash_attention_causal_fwd(q, k, v)
            assert all(torch.equal(a, b) for a, b in zip(again, (o, m, l))), \
                f"{what}: the forward differs from run to run"
            del again
        op, mp, lp = FA.flash_attention_causal_fwd_plain(q, k, v)
        di = (op.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, mp, lp, di)
        plan, _, plan_table = FA._dkv_tables(B, T, H, KVH, hd, dev)
        _lib.reset_launch_counts()
        dk, dv = FA.flash_attention_causal_bwd_dkv(*bwd)
        assert _lib.launch_counts()[flash_names(dt, hd)[1]] == 1, what
        assert _lib.launch_counts()["flash_attention_causal_bwd_dkv_combine"] == (1 if plan.combine else 0), what
        if (dt != f32 and hd in (384, 512)) or FA.uses_tf32("dkv", dt, hd):
            # kernel 18's sliced and TF32 instances where the plan splits key tiles
            again = FA.flash_attention_causal_bwd_dkv(*bwd)
            assert torch.equal(again[0], dk) and torch.equal(again[1], dv), f"{what}: differs from run to run"
            del again
            combine_against_plain(what, plan, plan_table, dk, dv, 63)
        _lib.reset_launch_counts()
        dq = FA.flash_attention_causal_bwd_dq(*bwd)
        assert _lib.launch_counts()[flash_names(dt, hd)[2]] == 1, what
        if (dt != f32 and hd in (384, 512)) or FA.uses_tf32("dq", dt, hd):
            # kernel 19's sliced and TF32 instances on GQA batches
            assert torch.equal(FA.flash_attention_causal_bwd_dq(*bwd), dq), f"{what}: dq differs from run to run"
        dkp, dvp = FA.flash_attention_causal_bwd_dkv_plain(*bwd)
        errs = {"o_abs": (o.float() - op.float()).abs().max().item(), "m_abs": (m - mp).abs().max().item(),
                "l_rel": rel(l, lp), "dq_rel": rel(dq, FA.flash_attention_causal_bwd_dq_plain(*bwd)),
                "dk_rel": rel(dk, dkp), "dv_rel": rel(dv, dvp)}
        check(what, dt, errs)
        batched.append({"dtype": str(dt)[6:], "B": B, "T": T, "H": H, "KVH": KVH, "hd": hd, "errs": errs,
                        "kernels": flash_names(dt, hd), "split_key_tiles": len(plan.combine)})
        del q, k, v, do, o, m, l, op, mp, lp, di, bwd, dk, dv, dq, dkp, dvp

    # the threshold sweep below T 1024: the kernels against the dense oracle, forward and backward
    sweep = []
    for T in (512, 1024):
        B, H, KVH, hd = 1, 32, 8, 128
        q, k, v, do = flash_inputs(dev, gen, B, T, H, KVH, hd)
        q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
        cfg = L.LlamaConfig(num_heads=H, num_kv_heads=KVH, head_dim=hd)
        pos = torch.arange(T, device=dev)[None].expand(B, T)
        valid = torch.ones(B, T, dtype=torch.bool, device=dev)
        gout = do.reshape(B, T, H * hd)
        kern = events_fwd_bwd(lambda a, b, c: L._flash_attention_causal(a, b, c, cfg), (q, k, v), gout)
        orac = events_fwd_bwd(lambda a, b, c: L._attention(a, b, c, pos, valid, cfg), (q, k, v), gout)
        sweep.append({"T": T, "kernels": kern, "oracle": orac,
                      "kernels_faster_both_ways": kern["fwd_ms"] + kern["bwd_ms"] < orac["fwd_ms"] + orac["bwd_ms"]})
        del q, k, v, do, gout
        torch.cuda.empty_cache()
    # the instances of kernels 17-19: the wgmma kernels (bf16 and f16; the
    # forward at hd 128-512, dK/dV and dQ at 128 and 256) hold wgmma (HGMMA)
    # and TMA loads (UTMALDG) and no local stores; the bf16 instances at hd
    # 128 and 256 keep FLASH_BF16_SASS's counts; the wide family (f32, bf16,
    # f16) runs f32 FMAs (FFMA) with no tensor-core product and no local stores
    flash_kernels = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
    wide_kernels = ("flash_wide_fwd_kernel", "flash_wide_dkv_kernel", "flash_wide_dq_kernel")
    tf32_kernels = ("flash_tf32_fwd_kernel", "flash_tf32_dkv_kernel", "flash_tf32_dq_kernel")
    streamed_kernels = ("flash_streamed_fwd_kernel",)
    all_kernels = flash_kernels + wide_kernels + tf32_kernels + streamed_kernels
    sass, wg_sass, fn = sass_of(_lib.build()), {}, None
    for line in (sass or "").splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if any(k in fn for k in all_kernels) else None
            if fn:
                wg_sass[fn] = {"HGMMA": 0, "UTMALDG": 0, "STL": 0, "FFMA": 0, "HMMA": 0, "HGMMA_TF32": 0}
        elif fn:
            for op in ("HGMMA", "UTMALDG", "STL", "FFMA", "HMMA"):
                wg_sass[fn][op] += f" {op}" in line
            wg_sass[fn]["HGMMA_TF32"] += " HGMMA" in line and ".TF32" in line

    def instance(name):  # (type, hd) of a wgmma kernel's mangled name
        hd_ = re.search(r"ILi(\d+)E", name)
        return ("bf16" if "bfloat16" in name else "f16" if "half" in name else "?", int(hd_.group(1)) if hd_ else 0)

    for kern, dims in zip(flash_kernels, (FA.WGMMA_HEAD_DIMS[k] for k in FLASH_KERNELS)):
        inst = {n: c for n, c in wg_sass.items() if kern in n}
        assert sass is None or (len(inst) == 2 * len(dims) and all(c["HGMMA"] and c["UTMALDG"] and not c["STL"]
                                                                   for c in inst.values())), f"3p {kern} SASS {inst}"
        got = {instance(n): (c["HGMMA"], c["UTMALDG"]) for n, c in inst.items()}
        assert sass is None or set(got) == {(t, h) for t in ("bf16", "f16") for h in dims}, f"3p {kern} {got}"
        for hd_, counts in FLASH_BF16_SASS[kern].items():
            assert sass is None or got[("bf16", hd_)] == counts, f"3p {kern} bf16 hd {hd_}: {got}, was {counts}"
    for kern in wide_kernels:
        inst = {n: c for n, c in wg_sass.items() if kern in n}
        assert sass is None or (len(inst) == 3 and all(c["FFMA"] and not c["STL"] and not c["HGMMA"]
                                                       for c in inst.values())), f"3p {kern} SASS {inst}"
    # kernels 17-19's f32 instances (hd 128, 256): every HGMMA a TF32 one, TMA loads, no local stores
    for kern in tf32_kernels:
        inst = {n: c for n, c in wg_sass.items() if kern in n}
        assert sass is None or (len(inst) == 2 and all(c["HGMMA"] and c["HGMMA"] == c["HGMMA_TF32"] and c["UTMALDG"]
                                                       and not c["STL"] for c in inst.values())), \
            f"3p {kern} SASS {inst}"
    # kernel 17's streamed instances (bf16, f16 from hd 640): wgmma, TMA loads, no local stores
    inst = {n: c for n, c in wg_sass.items() if streamed_kernels[0] in n}
    assert sass is None or (len(inst) == 2 and all(c["HGMMA"] and c["UTMALDG"] and not c["STL"] and not c["HGMMA_TF32"]
                                                   for c in inst.values())), f"3p streamed SASS {inst}"
    emit("flash_train_kernels", shapes=out, batched=batched, threshold_sweep=sweep, sass=wg_sass,
         registers=registers_of(_lib.build(), all_kernels),
         route_line={"T_min": 1024, "note": "the JAX package's line (_flash_ok), kept"})
    return out


def flash_qlora(params, dev, rank=64, alpha=16.0, chunk=512, steps=5):
    """4r: QLoRA training through kernels 17-19 on 4b's double-quantized
    Llama-3-8B (``lora_train_step``, rank 64, alpha 16 on all seven targets,
    ``adamw8bit``, ``token_chunk`` 512).  (a) All 32 layers, ids [1, 2049]
    (T 2048: 4d's token count in one sequence), ``steps`` steps: the losses,
    wall ms (median of steps 2-5), the launches (kernels 17, 18 and 19 32
    times a step each, kernel 6 255, kernel 14 once), the peak memory, and
    one more step under the profiler, device ms by class.  (b) 4 layers at
    T 2048: the flash route against the same step on the dense oracle
    (``sliding_window = 1 << 20``: the same mask, off the flash route), the
    first step's loss within rel 1e-3, the second step's device ms of each.
    (c) 4 layers at T 8192, the flash route only: one step, its wall and peak
    memory (the oracle's f32 scores alone would take 8.6 GB a layer).  (d)
    The same 32 layers at T 2048 in f16 (the NF4 payloads as they are, the
    float leaves cast to f16): three steps, the losses finite and falling,
    kernels 17-19's f16 instances 32 times a step, device ms by class.  (e)
    4 layers at T 2048 in f32 (the float leaves cast to f32) on the TF32
    forward, dK/dV and dQ, 8 launches of each in its 2 steps (none of the
    wide family), against the same step on the f32 oracle: the first step's
    loss within rel 1e-4 (kernels 17-19's TF32 instances).  Returns the
    launches of each kernels-line entry of kernels 17-19: bf16 from (a), f16
    from (d), the TF32 forward, dK/dV and dQ from (e)."""
    import dataclasses

    import torch

    from bitsandbytes_tpu_torch import optim as O
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = L.LlamaConfig.llama3_8b()
    Lyr = cfg.num_layers
    assert len(params["layers"]) == Lyr

    def ids_of(T, seed):
        return torch.randint(0, cfg.vocab_size, (1, T + 1), generator=torch.Generator(device=dev).manual_seed(seed),
                             device=dev)

    def cast_floats(tree, dtype):
        """``tree`` with its float tensors (embedding, norms, lm_head) in
        ``dtype``; quantized weights as they are."""
        from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor
        from bitsandbytes_tpu_torch.nn.parametrize import map_tree

        return map_tree(lambda _, x: x if isinstance(x, QuantizedTensor) or not x.is_floating_point()
                        else x.to(dtype), tree)

    def setup(cfg_):
        lora = L.add_lora(cfg_, rank=rank, alpha=alpha, targets=LORA_TARGETS,
                          generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        return lora, O.adamw8bit(L.lora_parameters(lora), 1e-3)

    def run(tree, cfg_, ids, n):
        """``n`` steps from fresh adapters: losses, wall ms, launches, peak
        bytes above what was held before, then one profiled step."""
        lora, opt = setup(cfg_)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, walls = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            losses.append(L.lora_train_step(tree, lora, opt, ids, cfg_, token_chunk=chunk).item())
            walls.append((time.perf_counter() - t0) * 1e3)
        counts = {k_: c for k_, c in launch_counts().items() if c}
        peak = torch.cuda.max_memory_allocated() - base
        _, events, prof_wall = profiled(lambda: L.lora_train_step(tree, lora, opt, ids, cfg_, token_chunk=chunk))
        dev_ms = sum(self_dev_us(e) for e in events) / 1e3
        assert all(math.isfinite(x) for x in losses), f"4r losses {losses}"
        del lora, opt
        return {"losses": losses, "wall_ms": walls, "launches": counts, "peak_bytes": peak,
                "profiled_step": {"wall_ms": prof_wall, "device_ms": dev_ms, "device_busy_share": dev_ms / prof_wall,
                                  "by_class": by_class(events, FLASH_CLASSES)}}

    # (a) all 32 layers at T 2048
    T = 2048
    assert L._flash_ok(cfg, T, cfg.head_dim, dev)
    a = run(params, cfg, ids_of(T, 70), steps)
    want = {name: steps * Lyr for name in FLASH_TRAIN}
    want.update(dequantize_paired_fast_dq=steps * (8 * Lyr - 1), optimizer_update_8bit=steps)
    if dkv_combines(dev, 1, T, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim):
        want["flash_attention_causal_bwd_dkv_combine"] = steps * Lyr
    assert a["launches"] == want, f"4r(a) launches {a['launches']} != {want}"
    assert a["losses"][-1] < a["losses"][0], f"4r(a) losses {a['losses']}"
    a["wall_ms_median_2_5"] = statistics.median(a["wall_ms"][1:])
    a["tokens_per_s"] = T / (a["wall_ms_median_2_5"] * 1e-3)

    # (b) 4 layers at T 2048: the flash route against the oracle's
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    cfg4_dense = dataclasses.replace(cfg4, sliding_window=1 << 20)
    assert not L._flash_ok(cfg4_dense, T, cfg.head_dim, dev)
    p4 = {**params, "layers": params["layers"][:4]}
    ids_b = ids_of(T, 71)
    flash4 = run(p4, cfg4, ids_b, 2)
    dense4 = run(p4, cfg4_dense, ids_b, 2)
    assert all(flash4["launches"][n] == 2 * 4 for n in FLASH_TRAIN), f"4r(b) flash {flash4['launches']}"
    assert not any(n in dense4["launches"] for n in FLASH_TRAIN), f"4r(b) oracle {dense4['launches']}"
    loss_rel = abs(flash4["losses"][0] - dense4["losses"][0]) / abs(dense4["losses"][0])
    assert loss_rel <= 1e-3, f"4r(b) loss flash {flash4['losses'][0]} against the oracle's {dense4['losses'][0]}"

    # (c) 4 layers at T 8192, the flash route
    T8 = 8192
    c8 = run(p4, cfg4, ids_of(T8, 72), 1)
    assert all(c8["launches"][n] == 4 for n in FLASH_TRAIN), f"4r(c) {c8['launches']}"
    del p4
    torch.cuda.empty_cache()

    # (d) all 32 layers at T 2048 in f16: the wgmma kernels' f16 instances
    cfg16 = dataclasses.replace(cfg, dtype=torch.float16)
    p16 = cast_floats(params, torch.float16)
    d = run(p16, cfg16, ids_of(T, 73), 3)
    assert all(d["launches"].get(n) == 3 * Lyr for n in FLASH_TRAIN), f"4r(d) launches {d['launches']}"
    assert not any(n in d["launches"] for n in FLASH_TRAIN_WIDE), f"4r(d) launches {d['launches']}"
    assert d["losses"][-1] < d["losses"][0], f"4r(d) losses {d['losses']}"
    del p16
    torch.cuda.empty_cache()

    # (e) 4 layers at T 2048 in f32: the TF32 forward, dK/dV and dQ against
    # the f32 oracle
    cfg32 = dataclasses.replace(cfg4, dtype=torch.float32)
    cfg32_dense = dataclasses.replace(cfg32, sliding_window=1 << 20)
    p32 = cast_floats({**params, "layers": params["layers"][:4]}, torch.float32)
    ids_e = ids_of(T, 74)
    names32 = flash_names(torch.float32, cfg.head_dim)
    assert names32 == FLASH_TF32, names32
    flash32 = run(p32, cfg32, ids_e, 2)
    dense32 = run(p32, cfg32_dense, ids_e, 2)
    assert all(flash32["launches"].get(n) == 2 * 4 for n in names32), f"4r(e) flash {flash32['launches']}"
    assert all(flash32["launches"].get(n) is None for n in FLASH_TRAIN_WIDE), f"4r(e) flash {flash32['launches']}"
    assert not any(n in dense32["launches"] for n in FLASH_TRAIN + FLASH_TRAIN_WIDE + FLASH_TF32), \
        f"4r(e) {dense32['launches']}"
    loss_rel32 = abs(flash32["losses"][0] - dense32["losses"][0]) / abs(dense32["losses"][0])
    assert loss_rel32 <= 1e-4, f"4r(e) loss {flash32['losses'][0]} against the f32 oracle's {dense32['losses'][0]}"
    del p32
    emit("flash_qlora", config="llama3_8b", compress_statistics=True, lora_rank=rank, lora_alpha=alpha,
         targets=list(LORA_TARGETS), optimizer="adamw8bit", token_chunk=chunk,
         all_layers={"layers": Lyr, "ids": [1, T + 1], "steps": steps, **a},
         four_layers_vs_oracle={"ids": [1, T + 1], "loss_rel_diff": loss_rel, "flash": flash4, "oracle": dense4},
         four_layers_t8192={"ids": [1, T8 + 1], **c8,
                            "oracle_scores_bytes_a_layer": 1 * cfg.num_heads * T8 * T8 * 4},
         all_layers_f16={"layers": Lyr, "ids": [1, T + 1], "steps": 3, **d},
         four_layers_f32_vs_oracle={"ids": [1, T + 1], "loss_rel_diff": loss_rel32, "flash": flash32,
                                    "oracle": dense32})
    launches = {name: a["launches"][name] for name in FLASH_TRAIN}
    launches.update({name + "_f16": d["launches"][name] for name in FLASH_TRAIN})
    launches.update({name: flash32["launches"][name] for name in names32})
    return launches


def flash_cpu_check(dev, dtype=None, hd=128):
    """5l: a 2-layer Llama (bf16 unless ``dtype`` says; hidden 512, H 4 over
    2 KV heads, hd 128, or at a wider ``hd`` H 2 over 1 KV head, hidden 2
    hd; fused NF4, rank-8 adapters on all seven targets, ``b`` non-zero) at
    T 1024: ``lm_loss`` and its adapter gradients through kernels 17-19 on
    the card (the wgmma kernels in bf16 and f16; in f32 the TF32 forward,
    dK/dV and dQ at hd 128, the wide family at hd 512; at hd 512 in 16
    bits their sliced wgmma instances; at hd 640 in 16 bits the forward's
    streamed instance, dK/dV and dQ on the wide family)
    against the CPU port through their plain versions (the CPU's route
    patched to the flash one), the loss within rel 1e-3, the gradients
    within rtol 2e-2 / atol 2e-3; the card's launches 2 of each kernel the
    route names, and 2 of kernel 18's combine where its plan splits a key
    tile at this shape."""
    import torch

    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.ops import launch_counts, reset_launch_counts

    hidden, heads, kv_heads = (512, 4, 2) if hd == 128 else (2 * hd, 2, 1)
    cfg = L.LlamaConfig(vocab_size=1024, hidden_size=hidden, intermediate_size=1024, num_layers=2, num_heads=heads,
                        num_kv_heads=kv_heads, head_dim=hd, dtype=dtype or torch.bfloat16)
    names = flash_names(cfg.dtype, cfg.head_dim)
    T = 1024
    assert L._flash_ok(cfg, T, cfg.head_dim, dev) and not L._flash_ok(cfg, T, cfg.head_dim, torch.device("cpu"))
    cpu_float = L.init_params(cfg, torch.Generator().manual_seed(80), device="cpu")
    cpu_params = L.quantize_params_4bit(cpu_float, fuse=True)
    gpu_params = L.quantize_params_4bit(tree_to(cpu_float, dev), fuse=True)
    ids = torch.randint(0, cfg.vocab_size, (1, T + 1), generator=torch.Generator().manual_seed(81))
    lora0 = L.add_lora(cfg, rank=8, alpha=16.0, targets=LORA_TARGETS, generator=torch.Generator().manual_seed(82),
                       device="cpu")
    g = torch.Generator().manual_seed(83)
    for layer in lora0["layers"]:
        for ad in layer.values():
            ad["b"] = torch.randn(ad["b"].shape, generator=g) * 0.02

    def fresh(device):
        return {"layers": [{n: {k: t.detach().clone().to(device).requires_grad_() for k, t in ad.items()}
                            for n, ad in layer.items()} for layer in lora0["layers"]]}

    lg = fresh(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    loss_g = L.lm_loss(gpu_params, lg, ids.to(dev), cfg)
    loss_g.backward()
    torch.cuda.synchronize()
    counts = {k: c for k, c in launch_counts().items() if c}
    assert all(counts.get(n) == cfg.num_layers for n in names), f"5l launches {counts}"
    others = FLASH_TRAIN + FLASH_TRAIN_WIDE + ("flash_attention_causal_fwd_sliced",
                                               "flash_attention_causal_bwd_dkv_sliced",
                                               "flash_attention_causal_bwd_dq_sliced",
                                               "flash_attention_causal_fwd_streamed") + FLASH_TF32
    assert not any(counts.get(n) for n in others if n not in names), f"5l launches {counts}"
    combines = cfg.num_layers * dkv_combines(dev, 1, T, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    assert counts.get("flash_attention_causal_bwd_dkv_combine", 0) == combines, f"5l launches {counts}"
    lc = fresh("cpu")
    route = L._flash_ok
    L._flash_ok = lambda cfg_, T_, hd_, device_: route(cfg_, T_, hd_, torch.device("cuda"))
    try:
        loss_c = L.lm_loss(cpu_params, lc, ids, cfg)
        loss_c.backward()
    finally:
        L._flash_ok = route
    loss_rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    assert loss_rel <= 1e-3, f"5l loss card {loss_g.item()} against the CPU's {loss_c.item()}"
    grad_err = 0.0
    for tg, tc in zip(L.lora_parameters(lg), L.lora_parameters(lc)):
        a, b = tg.grad.cpu(), tc.grad
        assert torch.allclose(a, b, rtol=2e-2, atol=2e-3), "5l adapter gradients differ from the CPU's"
        grad_err = max(grad_err, (a - b).abs().max().item())
    emit("cpu_check_flash_train", dtype=str(cfg.dtype)[6:], layers=cfg.num_layers, hidden=cfg.hidden_size,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, seq=T, lora_rank=8,
         loss_card=loss_g.item(), loss_cpu=loss_c.item(), loss_rel_diff=loss_rel, max_abs_grad_diff=grad_err,
         launches=counts)
    del gpu_params, lg
    torch.cuda.empty_cache()
    return counts


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
    from bitsandbytes_tpu_torch.ops import _lib
    from bitsandbytes_tpu_torch.ops import gemm4bit_paired as PT
    from bitsandbytes_tpu_torch.ops.gemm4bit_paired import (
        _sm_count,
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
        StateLeaf,
        UpdateScalars,
        optimizer_update_8bit_,
        optimizer_update_8bit_multi_,
        optimizer_update_8bit_plain,
        optimizer_update_leaves_,
    )
    from bitsandbytes_tpu_torch.ops.gemm4bit import (
        dequantize_4bit_2d,
        dequantize_4bit_2d_dq,
        dequantize_4bit_2d_dq_plain,
        dequantize_4bit_2d_plain,
        gemm_4bit_fused,
        gemm_4bit_fused_dq,
        gemm_4bit_fused_dq_plain,
        gemm_4bit_fused_plain,
        gemm_4bit_nt_fused,
        gemm_4bit_nt_fused_plain,
        nt_plan,
    )
    from bitsandbytes_tpu_torch.ops import gemm4bit as K9
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

    def sass_stl(kernel):
        """Local stores (``STL``) in the SASS of the instances of ``kernel``
        in the built library, from ``cuobjdump -sass``: the most before an
        instance's first barrier, where the codebooks are staged (a parameter
        indexed by a register is copied to local memory there, one store for
        each 8 or 16 of its bytes), and how many in all (register spills).
        None without the tool."""
        sass = sass_of(so)
        if sass is None:
            return None
        found, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                fn = fn if f"{kernel}_kernel" in fn and f"de{kernel}_kernel" not in fn else None
                if fn:
                    found[fn] = {"barrier": False, "before": 0, "stl": 0}
            elif fn and " BAR" in line:
                found[fn]["barrier"] = True
            elif fn and " STL" in line:
                found[fn]["stl"] += 1
                found[fn]["before"] += not found[fn]["barrier"]
        assert found, f"no {kernel} kernel in the SASS"
        return {"instances": len(found), "stl_before_first_barrier_max": max(f["before"] for f in found.values()),
                "stl_all_instances": sum(f["stl"] for f in found.values())}

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

    # -- 3a. kernel 1: quantize -------------------------------------------
    # bit for bit against its plain version: nf4, fp4 and int4 at blocksizes
    # 32, 64, 256 and 4096 and af4 at 64, W in f32, bf16 and f16, a count of
    # whole blocks that ends inside a tile, an all-zero block, both rounding
    # modes; each 16-bit W also against the kernel on its f32 copy.  Their
    # data comes from a generator of their own, so that the main paths' inputs
    # (drawn from gen) stay those of earlier runs.
    gen_q = torch.Generator(device=dev).manual_seed(15)
    q4_cases = []
    for qt, qbs in [(t, b) for t in ("nf4", "fp4", "int4") for b in (32, 64, 256, 4096)] + [("af4", 64)]:
        n = qbs * (40960 // qbs + 3)  # 2.5 tiles of 16384 elements and three blocks
        base = torch.randn(n, generator=gen_q, device=dev)
        base[qbs : 2 * qbs] = 0.0
        u = torch.rand(n, generator=gen_q, device=dev)
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            xd = base.to(dt)
            for uu in (None, u):
                qk, ak = quantize_4bit_codes(xd, qt, qbs, uu)
                qp, ap_ = quantize_4bit_codes_plain(xd, qt, qbs, uu)
                what = f"quantize {qt} bs{qbs} {str(dt)[6:]} stochastic={uu is not None}"
                assert bits_equal(qk, qp) and bits_equal(ak, ap_), f"{what}: differs from its plain version"
                qf, af = quantize_4bit_codes(xd.float(), qt, qbs, uu)
                assert bits_equal(qk, qf) and bits_equal(ak, af), f"{what}: differs from its f32 copy"
        q4_cases.append(f"{qt} bs{qbs} n{n} f32/bf16/f16 zero-block nearest+stochastic")
    # gate_up, as the loader quantizes it: bf16 W, and its f32 copy (the
    # loader's former cast)
    N, K = LINEARS["gate_up"]
    Wb = torch.randn(N, K, generator=gen, device=dev).to(torch.bfloat16)
    Wb[0, :bs] = 0.0  # an all-zero block
    xb = Wb.reshape(-1)
    x = xb.float()
    u = torch.rand(x.numel(), generator=gen, device=dev)
    moved = {}
    for qt in ("nf4", "fp4"):
        for uu in (None, u):
            qk, ak = quantize_4bit_codes(xb, qt, bs, uu)
            qp, ap_ = quantize_4bit_codes_plain(x, qt, bs, uu)
            assert bits_equal(qk, qp) and bits_equal(ak, ap_), f"quantize gate_up {qt} stochastic={uu is not None}"
            assert bits_equal(qk, quantize_4bit_codes(x, qt, bs, uu)[0]), f"quantize gate_up {qt}: bf16 vs f32"
        moved[qt] = (qk != quantize_4bit_codes(xb, qt, bs)[0]).float().mean().item()
        assert 0.1 < moved[qt] < 0.4, f"stochastic quantize moved {moved[qt]} of the codes ({qt})"
    n_el = N * K

    def k1_row(xd, uu, nbytes):
        return {"ms": cuda_time(lambda: quantize_4bit_codes(xd, "nf4", bs, uu), flush_l2=True)["median"],
                "device_ms": cuda_time(lambda: quantize_4bit_codes(xd, "nf4", bs, uu), flush_l2=True,
                                       hold=True)["median"],
                "bytes": nbytes, "bound_ms": bound_ms(nbytes, (28 if uu is not None else 20) * n_el,
                                                      PEAK_F32_FLOPS)[0],
                "canary_bound_ms": nbytes / canary_bs * 1e3}

    k1_bytes = {"float32": n_el * 5 + n_el // bs * 4, "bfloat16": n_el * 3 + n_el // bs * 4}
    k1_f32 = k1_row(x, None, k1_bytes["float32"])
    k1_bf16 = k1_row(xb, None, k1_bytes["bfloat16"])
    sto = {"float32": k1_row(x, u, k1_bytes["float32"] + n_el * 4),
           "bfloat16": k1_row(xb, u, k1_bytes["bfloat16"] + n_el * 4),
           "plain_ms": cuda_time(lambda: quantize_4bit_codes_plain(x, "nf4", bs, u), n=5)["median"],
           "moved_share": moved}
    entry(
        "quantize_4bit_codes", k1_f32["ms"],
        cuda_time(lambda: quantize_4bit_codes_plain(x, "nf4", bs), n=5)["median"],
        None, k1_bytes["float32"], 20 * n_el, PEAK_F32_FLOPS, 0.0,
        shape=[N, K], device_ms=k1_f32["device_ms"], bf16=k1_bf16, stochastic_u=sto, cases=q4_cases,
        sass_stl=sass_stl("quantize_4bit_codes"),
        note="ms: gate_up f32 W, nf4 bs 64, the L2 flushed, the host in the window; device_ms the same held "
             "out (hold=True); bf16: the same weight in bf16, as the loader passes it; stochastic_u: uniforms "
             "given (4 B more an element)",
    )
    del Wb, xb, x, qk, ak, qp, ap_, qf, af, u, base

    def dequant_layer(run, plain, scale_bytes, resolved=None, resolved_key="kernel3_resolved", beside=None):
        """A dequantize kernel (3, 6 or 10, plain or _dq) at each of the four
        linears in bf16, f16 and f32: bit for bit against its plain version, a
        second call and (a _dq mode) its plain mode on the resolved absmax;
        then device time with the host held out, the store floor (zero_() of
        the same W: its bytes written, nothing read) and, given ``resolved``,
        the plain mode's beside it (``resolved_key``), and each yardstick of
        ``beside`` (key: (name, dtype) -> call, timed, not compared).  Sums
        over the layer by output type."""
        timed = dict(beside or {})
        if resolved is not None:
            timed[resolved_key] = resolved
        per, tot = {}, {}
        for name, (N, K) in LINEARS.items():
            for dt in (torch.bfloat16, torch.float16, torch.float32):
                key = str(dt)[6:]
                Wk = run(name, dt)
                assert bits_equal(Wk, plain(name, dt)), f"dequantize {name} {key}: differs from its plain version"
                assert bits_equal(Wk, run(name, dt)), f"dequantize {name} {key}: a second call differs"
                assert resolved is None or bits_equal(Wk, resolved(name, dt)), \
                    f"dequantize_dq {name} {key}: differs from kernel 3 on the resolved absmax"
                row = {"device_ms": cuda_time(lambda: run(name, dt), flush_l2=True, hold=True)["median"],
                       "store_floor_ms": cuda_time(lambda: Wk.zero_(), flush_l2=True, hold=True)["median"]}
                for tk, fn in timed.items():
                    row[f"{tk}_device_ms"] = cuda_time(lambda: fn(name, dt), flush_l2=True, hold=True)["median"]
                nbytes = N * K // 2 + scale_bytes(name) + N * K * dt.itemsize
                row.update(bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_S * 1e3,
                           canary_bound_ms=nbytes / canary_bs * 1e3)
                per.setdefault(name, {})[key] = row
                for k, v in row.items():
                    tot.setdefault(key, {}).setdefault(k, 0.0)
                    tot[key][k] += v
                del Wk
        return {"per_linear": per, "layer_device_ms": {k: v["device_ms"] for k, v in tot.items()},
                "layer_store_floor_ms": {k: v["store_floor_ms"] for k, v in tot.items()},
                "layer_canary_bound_ms": {k: v["canary_bound_ms"] for k, v in tot.items()},
                **{f"layer_{tk}_device_ms": {k: v[f"{tk}_device_ms"] for k, v in tot.items()} for tk in timed}}

    # -- 3b. kernel 2 (decode GEMM, M = 8) and kernel 3 (dequantize) ------
    weights = {}
    for name, (N, K) in LINEARS.items():
        Wf = torch.randn(N, K, generator=gen, device=dev) * K**-0.5
        weights[name] = QuantizedTensor.quantize(Wf, blocksize=bs)
        assert weights[name].state.layout == "paired"
    M = 8
    sms = _sm_count(0)

    def fw_device(run, plain, Wb, K, tot, per):
        """Kernel 2 (or 5) on one linear at M 16 (bf16) and M 8 (f16 A): each
        against its plain version, its output in A's type against the f32
        output rounded and a second call bit for bit; then device time with
        the host held out (hold=True) at M 8 and those two, as torch.matmul
        on the dequantized weight in A's type beside it; sums into tot, the
        row into per."""
        for Mx, dt, key in ((16, torch.bfloat16, "M16_bfloat16"), (8, torch.float16, "M8_float16")):
            Ax = torch.randn(Mx, K, generator=gen, device=dev).to(dt)
            o32, ref = run(Ax, torch.float32), plain(Ax)
            rel = ((o32 - ref).abs().max() / ref.abs().max()).item()
            o = run(Ax)
            assert rel <= 1e-3 and torch.equal(o, o32.to(dt)) and torch.equal(o, run(Ax)), \
                f"gemm M{Mx} {dt}: rel {rel}, its {dt} output, or a second call differs"
            Wx = Wb.to(dt)
            for k, fn in ((key, lambda: run(Ax)), (key + "_library", lambda: torch.matmul(Ax, Wx.t()))):
                per[k + "_device_ms"] = cuda_time(fn, flush_l2=True, hold=True)["median"]
                tot[k] = tot.get(k, 0.0) + per[k + "_device_ms"]
            del Wx
        per["device_ms"] = cuda_time(lambda: run(A), flush_l2=True, hold=True)["median"]
        per["library_device_ms"] = cuda_time(lambda: torch.matmul(A, Wb.t()), flush_l2=True, hold=True)["median"]
        tot["device"] = tot.get("device", 0.0) + per["device_ms"]
        tot["lib_device"] = tot.get("lib_device", 0.0) + per["library_device_ms"]

    def fw_by_M(tot):
        return {"M8_bfloat16": tot["device"], "M8_bfloat16_library": tot["lib_device"],
                **{k: tot[k] for k in ("M16_bfloat16", "M16_bfloat16_library", "M8_float16", "M8_float16_library")}}

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
            assert torch.equal(od, gemm_4bit_paired(Ad, P, am_t, code, bs, (N, K))), f"gemm {name} {dt}: a second call"
            a_modes[str(dt)[6:]] += cuda_time(lambda: gemm_4bit_paired(Ad, P, am_t, code, bs, (N, K)),
                                              flush_l2=True)["median"]
        out_bf = gemm_4bit_paired(A, P, am_t, code, bs, (N, K))
        assert torch.equal(out_bf, out.to(torch.bfloat16)), f"gemm {name}: bf16 output"
        assert torch.equal(out_bf, gemm_4bit_paired(A, P, am_t, code, bs, (N, K))), f"gemm {name}: a second call"
        Wb = dequantize_paired_fast_plain(P, am_t, units, bs, torch.bfloat16)
        ms = cuda_time(lambda: gemm_4bit_paired(A, P, am_t, code, bs, (N, K)), flush_l2=True)["median"]
        pms = cuda_time(lambda: gemm_4bit_paired_plain(A, P, am_t, units, bs), n=5)["median"]
        lms = cuda_time(lambda: torch.matmul(A, Wb.t()), flush_l2=True)["median"]
        nbytes = M * K * 2 + N * K // 2 + (K // bs) * N * 4 + M * N * 2
        k_per_split, splits = PT.gemm_plan(M, N, K, bs, sms)
        per_shape.append({"linear": name, "N": N, "K": K, "M": M, "ms": ms, "plain_ms": pms,
                          "library_ms": lms, "bytes": nbytes,
                          "bound_ms": bound_ms(nbytes, 2 * M * N * K, PEAK_BF16_FLOPS)[0],
                          "rel_err": rel, "splits": splits, "k_per_split": k_per_split})
        fw_device(lambda X, od=None: gemm_4bit_paired(X, P, am_t, code, bs, (N, K), out_dtype=od),
                  lambda X: gemm_4bit_paired_plain(X, P, am_t, units, bs), Wb, K, tot, per_shape[-1])
        tot["ms"] += ms
        tot["plain"] += pms
        tot["lib"] += lms
        tot["bytes"] += nbytes
        tot["ops"] += 2 * M * N * K
        tot["err"] = max(tot["err"], (out - ref).abs().max().item())
        del Wb
    emit("k2_splits", sms=sms, plan={p["linear"]: [p["k_per_split"], p["splits"]] for p in per_shape})
    entry("gemm_4bit_paired", tot["ms"], tot["plain"], tot["lib"], tot["bytes"], tot["ops"],
          PEAK_BF16_FLOPS, tot["err"], per_shape=per_shape, a_dtype_ms=a_modes, device_ms=tot["device"],
          library_device_ms=tot["lib_device"], splits={p["linear"]: p["splits"] for p in per_shape},
          layer_device_ms_by_M=fw_by_M(tot),
          note="sum over one layer's 4 linears at M=8; a_dtype_ms: the same with f16 and f32 A; device_ms, "
               "library_device_ms: kernel 2 and torch.matmul on the bf16 weight with the host held out of the "
               "window (hold=True); layer_device_ms_by_M: device ms over the layer at M 16 and with f16 A, and "
               "torch.matmul's (_library)")

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
    dq_layer = dequant_layer(
        lambda name, dt: dequantize_paired_fast(weights[name].data, weights[name].state.absmax, code, bs, dt),
        lambda name, dt: dequantize_paired_fast_plain(weights[name].data, weights[name].state.absmax, units, bs,
                                                      dt),
        lambda name: LINEARS[name][1] // bs * LINEARS[name][0] * 4)
    entry(
        "dequantize_paired_fast",
        cuda_time(lambda: dequantize_paired_fast(P, am_t, code, bs), flush_l2=True)["median"],
        cuda_time(lambda: dequantize_paired_fast_plain(P, am_t, units, bs, torch.bfloat16), n=5)["median"],
        None, N * K // 2 + (K // bs) * N * 4 + N * K * 2, N * K, PEAK_F32_FLOPS, 0.0, shape=[N, K],
        out_dtype_ms=out_modes, device_ms=dq_layer["per_linear"]["gate_up"]["bfloat16"]["device_ms"], **dq_layer,
        note="ms: gate_up to bf16 with the host in the window; device_ms the same held out (hold=True); "
             "layer_device_ms: the four linears, each output type; store_floor_ms: zero_() of the same W",
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

    # -- 3d. the large-M threshold: kernels 2 and 5 against kernels 3 and 6 + matmul, device time
    sweep = []
    for name in ("gate_up", "down"):
        N, K = LINEARS[name]
        P, am_t = weights[name].data, weights[name].state.absmax
        qn = QuantizedTensor.quantize(torch.randn(N, K, generator=gen, device=dev) * K**-0.5, blocksize=bs,
                                      compress_statistics=True)
        dq = (qn.data, qn.state.absmax, qn.state.state2.absmax, qn.state.offset)
        for Mx in (8, 16, 32, 48, 64, 96, 128, 160, 192, 224, 256):
            A = torch.randn(Mx, K, generator=gen, device=dev).to(torch.bfloat16)
            t = {key: cuda_time(fn, n=10, flush_l2=True, hold=True)["median"] for key, fn in (
                ("gemm_kernel_ms", lambda: gemm_4bit_paired(A, P, am_t, code, bs, (N, K))),
                ("dequant_matmul_ms", lambda: torch.matmul(A, dequantize_paired_fast(P, am_t, code, bs).t())),
                ("gemm_dq_kernel_ms", lambda: gemm_4bit_paired_dq(A, *dq, code, bs, (N, K))),
                ("dequant_dq_matmul_ms", lambda: torch.matmul(A, dequantize_paired_fast_dq(*dq, code, bs).t())))}
            sweep.append({"linear": name, "M": Mx, "splits": PT.gemm_plan(Mx, N, K, bs, sms)[1], **t})
        del qn, dq
    emit("threshold_sweep", LARGE_M_THRESHOLD=G.LARGE_M_THRESHOLD, points=sweep,
         note="device ms (hold=True), bf16 A, median of 10, the L2 flushed before each call")
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

    # kernels 3 and 6 at ragged shapes: N/2 odd (a partial group of 8 row
    # pairs), K off the 1024-column tiles, blocksizes 8-4096, and Llama's down
    # (K/bs = 224: a nested column's blocks cross a 256-block boundary); each
    # output type against the plain version and a second call bit for bit,
    # kernel 6 against kernel 3 on the resolved absmax.  Payloads, scales and
    # nested codes are random: the quantizer takes only some blocksizes.
    # Every shape the wrappers take runs the one tile kernel.
    cases, g12 = [], torch.Generator(device=dev).manual_seed(12)  # gen's stream is left as it was
    for N, K, gbs in ((2, 32, 32), (18, 96, 32), (130, 4160, 64), (254, 2176, 128), (64, 8192, 4096),
                      (4096, 14336, 64), (34, 1040, 8), (6, 48, 16), (20, 2112, 96)):
        KB = K // gbs
        P = torch.randint(0, 256, (N // 2, K), dtype=torch.uint8, generator=g12, device=dev)
        am_t = torch.rand(KB, N, generator=g12, device=dev) * 2 + 0.01
        dq = (torch.randint(0, 256, (KB, N), dtype=torch.uint8, generator=g12, device=dev),
              torch.rand(-(-N * KB // 256), generator=g12, device=dev) + 0.5,
              torch.rand(1, generator=g12, device=dev))
        resolved = PT.nested_absmax_t(*dq)
        cg = get_4bit_code("nf4", gbs)
        ug = _units(_code_tuple(cg))
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            Wk = dequantize_paired_fast(P, am_t, cg, gbs, dt)
            assert bits_equal(Wk, dequantize_paired_fast_plain(P, am_t, ug, gbs, dt)), f"dequant {(N, K, gbs)} {dt}"
            assert bits_equal(Wk, dequantize_paired_fast(P, am_t, cg, gbs, dt)), f"dequant {(N, K, gbs)} {dt}: again"
            W6 = dequantize_paired_fast_dq(P, *dq, cg, gbs, dt)
            assert bits_equal(W6, dequantize_paired_fast_dq_plain(P, *dq, ug, gbs, dt)), \
                f"dequant_dq {(N, K, gbs)} {dt}"
            assert bits_equal(W6, dequantize_paired_fast_dq(P, *dq, cg, gbs, dt)), f"dequant_dq {(N, K, gbs)}: again"
            assert bits_equal(W6, dequantize_paired_fast(P, resolved, cg, gbs, dt)), \
                f"dequant_dq {(N, K, gbs)} {dt}: differs from kernel 3 on the resolved absmax"
        cases.append(f"dequant(_dq) N{N} K{K} bs{gbs} bf16/f16/f32")
        del P, am_t, dq, resolved, Wk, W6
    emit("dequant_ragged_shapes", passed=cases,
         note="kernels 3 and 6 bit for bit against their plain versions, a second call and (6) kernel 3 on the "
              "resolved absmax; every shape runs the one tile kernel")

    # kernels 2 and 5 on the tensor cores at ragged shapes: M 1-33 (one to four
    # n8 tiles, then the grid over M), N not a multiple of 16, blocksizes
    # 32-4096, most cut into splits of K; each 16-bit call against its plain version, a
    # second call bit for bit, its f32 output rounded bit for bit, and kernel
    # 5 against kernel 2 on the resolved absmax bit for bit
    cases = []
    for Mx, N, K, gbs in ((1, 2, 32, 32), (3, 18, 96, 32), (8, 130, 4160, 64), (13, 258, 2176, 128),
                          (16, 1030, 2048, 64), (17, 640, 2048, 32), (24, 66, 4096, 256), (31, 250, 8192, 4096),
                          (32, 4096, 14336, 64), (33, 646, 2048, 64), (5, 98, 768, 256), (9, 514, 1024, 512)):
        gcode = get_4bit_code("nf4", gbs)
        for compress in (False, True):
            qw = QuantizedTensor.quantize(torch.randn(N, K, generator=gen, device=dev), blocksize=gbs,
                                          compress_statistics=compress)
            st = qw.state
            am_t = st.dequant_absmax_t() if compress else st.absmax
            if compress:
                args = (qw.data, st.absmax, st.state2.absmax, st.offset)
                run = lambda X, od=None: gemm_4bit_paired_dq(X, *args, gcode, gbs, (N, K), out_dtype=od)  # noqa: E731
            else:
                run = lambda X, od=None: gemm_4bit_paired(X, qw.data, am_t, gcode, gbs, (N, K), out_dtype=od)  # noqa: E731
            for dt in (torch.bfloat16, torch.float16):
                A = torch.randn(Mx, K, generator=gen, device=dev).to(dt)
                o32 = run(A, torch.float32)
                ref = gemm_4bit_paired_plain(A, qw.data, am_t, units, gbs)
                rel = ((o32 - ref).abs().max() / ref.abs().max()).item()
                assert rel <= 1e-3, f"gemm tc {(Mx, N, K, gbs, compress, dt)}: rel {rel}"
                o16 = run(A)
                assert torch.equal(o16, o32.to(dt)) and torch.equal(o16, run(A)), \
                    f"gemm tc {(Mx, N, K, gbs, compress, dt)}: 16-bit output, or a second call differs"
                if compress:
                    assert torch.equal(o32, gemm_4bit_paired(A, qw.data, am_t, gcode, gbs, (N, K),
                                                             out_dtype=torch.float32)), \
                        f"gemm_dq tc {(Mx, N, K, gbs, dt)}: differs from kernel 2 on the resolved absmax"
            cases.append(f"gemm{'_dq' if compress else ''} tc M{Mx} N{N} K{K} bs{gbs} bf16/f16 "
                         f"splits {PT.gemm_plan(Mx, N, K, gbs, sms)[1]}")
            del qw, am_t
    emit("ragged_shapes_tc", passed=cases)

    # The wrapper alone decides which kernel a call takes (PT._gemm_uses_tc)
    # and passes it as tc with the plan; the C entry refuses a plan that
    # kernel cannot take, before it reads anything.
    Nr, Kr = 256, 1024
    qw = QuantizedTensor.quantize(torch.randn(Nr, Kr, generator=gen, device=dev), blocksize=64,
                                  compress_statistics=True)
    am_r = qw.state.dequant_absmax_t()
    out_r = torch.empty(4, Nr, dtype=torch.float32, device=dev)
    part_r = torch.empty(16 * 4 * Nr, dtype=torch.float32, device=dev)
    refused = []
    for what, dt, gbs, Kx, kps, splits, tc, part in (
            ("f32 A on the tensor cores", torch.float32, 64, Kr, 1024, 1, 1, None),
            ("blocksize 40 on the tensor cores", torch.bfloat16, 40, 1040, 1040, 1, 1, None),
            ("splits of part of a quantization block", torch.bfloat16, 256, Kr, 384, 3, 1, part_r),
            ("splits of part of a stage", torch.bfloat16, 32, Kr, 96, 11, 1, part_r),
            ("two splits without partials", torch.bfloat16, 64, Kr, 512, 2, 1, None),
            ("splits short of K", torch.bfloat16, 64, Kr, 256, 2, 1, part_r),
            ("an empty split", torch.bfloat16, 64, Kr, 512, 3, 1, part_r),
            ("the CUDA-core kernel with two splits", torch.bfloat16, 64, Kr, 512, 2, 0, part_r),
            ("f32 A split on the CUDA cores", torch.float32, 64, Kr, 512, 2, 0, part_r)):
        Ar = torch.zeros(4, Kr, dtype=dt, device=dev)
        err = _lib.lib().bnb_gemm_4bit_paired(
            Ar.data_ptr(), qw.data.data_ptr(), am_r.data_ptr(), None if part is None else part.data_ptr(),
            out_r.data_ptr(), 4, Nr, Kx, gbs, kps, splits, tc, _lib.host_f32(units), PT._KIND[dt], 1, _lib.stream(Ar))
        assert err != 0, f"gemm: a mismatched plan was taken ({what})"
        refused.append(what)
    Ar = torch.zeros(4, Kr, dtype=torch.bfloat16, device=dev)
    err = _lib.lib().bnb_gemm_4bit_paired_dq(
        Ar.data_ptr(), qw.data.data_ptr(), qw.state.absmax.data_ptr(), qw.state.state2.absmax.data_ptr(),
        qw.state.offset.data_ptr(), None, out_r.data_ptr(), 4, Nr, Kr, 64, 512, 2, 1, _lib.host_f32(units),
        ctypes.addressof(PT._dyn_decode()), PT._KIND[torch.bfloat16], 1, _lib.stream(Ar))
    assert err != 0, "gemm_dq: a mismatched plan was taken (two splits without partials)"
    refused.append("kernel 5: two splits without partials")
    torch.cuda.synchronize()
    del qw, am_r, out_r, part_r
    emit("gemm_mismatched_plans_refused", cases=refused)

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
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "k2": 0.0, "k2_dev": 0.0, "bytes": 0, "ops": 0, "err": 0.0}
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
            assert torch.equal(od, gemm_4bit_paired_dq(Ad, *args, code, bs, (N, K))), f"gemm_dq {name} {dt}: a second call"
            a_modes_dq[str(dt)[6:]] += cuda_time(lambda: gemm_4bit_paired_dq(Ad, *args, code, bs, (N, K)),
                                                 flush_l2=True)["median"]
        out_bf = gemm_4bit_paired_dq(A, *args, code, bs, (N, K))
        assert torch.equal(out_bf, out.to(torch.bfloat16)), f"gemm_dq {name}: bf16 output"
        assert torch.equal(out_bf, gemm_4bit_paired_dq(A, *args, code, bs, (N, K))), f"gemm_dq {name}: a second call"
        Wb = dequantize_paired_fast_dq_plain(*args, units, bs, torch.bfloat16)
        ms = cuda_time(lambda: gemm_4bit_paired_dq(A, *args, code, bs, (N, K)), flush_l2=True)["median"]
        k2 = cuda_time(lambda: gemm_4bit_paired(A, qt.data, am_t, code, bs, (N, K)), flush_l2=True)["median"]
        k2_dev = cuda_time(lambda: gemm_4bit_paired(A, qt.data, am_t, code, bs, (N, K)), flush_l2=True,
                           hold=True)["median"]
        pms = cuda_time(lambda: gemm_4bit_paired_dq_plain(A, *args, units, bs), n=5)["median"]
        lms = cuda_time(lambda: torch.matmul(A, Wb.t()), flush_l2=True)["median"]
        nb2 = st.state2.absmax.numel()
        nbytes = M * K * 2 + N * K // 2 + (K // bs) * N + nb2 * 4 + 4 + M * N * 2
        per_shape.append({"linear": name, "N": N, "K": K, "M": M, "ms": ms, "kernel2_resolved_ms": k2,
                          "kernel2_resolved_device_ms": k2_dev, "plain_ms": pms, "library_ms": lms, "bytes": nbytes,
                          "bound_ms": bound_ms(nbytes, 2 * M * N * K, PEAK_BF16_FLOPS)[0], "rel_err": rel,
                          "splits": PT.gemm_plan(M, N, K, bs, sms)[1]})
        fw_device(lambda X, od=None: gemm_4bit_paired_dq(X, *args, code, bs, (N, K), out_dtype=od),
                  lambda X: gemm_4bit_paired_dq_plain(X, *args, units, bs), Wb, K, tot, per_shape[-1])
        for key, v in (("ms", ms), ("plain", pms), ("lib", lms), ("k2", k2), ("k2_dev", k2_dev), ("bytes", nbytes),
                       ("ops", 2 * M * N * K)):
            tot[key] += v
        tot["err"] = max(tot["err"], (out - ref).abs().max().item())
        del Wb, am_t
    entry("gemm_4bit_paired_dq", tot["ms"], tot["plain"], tot["lib"], tot["bytes"], tot["ops"],
          PEAK_BF16_FLOPS, tot["err"], per_shape=per_shape, kernel2_resolved_ms=tot["k2"], a_dtype_ms=a_modes_dq,
          device_ms=tot["device"], library_device_ms=tot["lib_device"], kernel2_resolved_device_ms=tot["k2_dev"],
          splits={p["linear"]: p["splits"] for p in per_shape},
          layer_device_ms_by_M=fw_by_M(tot),
          note="sum over one layer's 4 nested linears at M=8; kernel2_resolved_ms is kernel 2 on "
               "the same weights with the absmax decoded to f32, timed in the same run; a_dtype_ms: "
               "with f16 and f32 A; device_ms, library_device_ms, kernel2_resolved_device_ms: the same with "
               "the host held out of the window (hold=True); layer_device_ms_by_M: device ms over the layer "
               "at M 16 and with f16 A")

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

    def nested_args(name):
        st_ = nested[name].state
        return nested[name].data, st_.absmax, st_.state2.absmax, st_.offset

    resolved_t = {name: nested[name].state.dequant_absmax_t() for name in LINEARS}
    dq_layer = dequant_layer(
        lambda name, dt: dequantize_paired_fast_dq(*nested_args(name), code, bs, dt),
        lambda name, dt: dequantize_paired_fast_dq_plain(*nested_args(name), units, bs, dt),
        lambda name: (LINEARS[name][1] // bs * LINEARS[name][0] + nested[name].state.state2.absmax.numel() * 4
                      + 4),
        resolved=lambda name, dt: dequantize_paired_fast(nested[name].data, resolved_t[name], code, bs, dt))
    del resolved_t
    entry(
        "dequantize_paired_fast_dq",
        cuda_time(lambda: dequantize_paired_fast_dq(*args, code, bs), flush_l2=True)["median"],
        cuda_time(lambda: dequantize_paired_fast_dq_plain(*args, units, bs, torch.bfloat16), n=5)["median"],
        None, N * K // 2 + (K // bs) * N + st.state2.absmax.numel() * 4 + 4 + N * K * 2, N * K,
        PEAK_F32_FLOPS, 0.0, shape=[N, K],
        kernel3_with_decode_ms=k3, out_dtype_ms=out_modes,
        device_ms=dq_layer["per_linear"]["gate_up"]["bfloat16"]["device_ms"], **dq_layer,
        note="kernel3_with_decode_ms: the nested absmax decoded by plain PyTorch ops, then kernel 3; device_ms: "
             "gate_up to bf16 with the host held out (hold=True); layer_device_ms: the four nested linears, each "
             "output type, beside kernel 3 on the resolved absmax (layer_kernel3_resolved_device_ms) and "
             "zero_() of the same W (layer_store_floor_ms)",
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
           "device_ms": cuda_time(lambda: quantize_blockwise8(xa, dyn, 256), flush_l2=True, hold=True)["median"],
           # a yardstick of the fixed cost at this size: one elementwise pass
           # over the same tensor (read and written once), device time
           "elementwise_pass_device_ms": cuda_time(lambda: xa.mul_(1.0), flush_l2=True, hold=True)["median"],
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
              "shape": q13["shape"], "blocksize": 256, "device_ms": q13["device_ms"],
              "elementwise_pass_device_ms": q13["elementwise_pass_device_ms"],
              "note": "the nested absmax of gate_up, as the double-quantized load quantizes it; ms with the "
                      "host in the window, device_ms held out (hold=True), both with the L2 flushed; "
                      "elementwise_pass_device_ms: mul_(1.0) over the same tensor",
              "lm_head": {"shape": [32000, 4096], "blocksize": 4096,
                          "ms": cuda_time(lambda: quantize_blockwise8(xl, dyn, 4096), flush_l2=True)["median"],
                          "device_ms": cuda_time(lambda: quantize_blockwise8(xl, dyn, 4096), flush_l2=True,
                                                 hold=True)["median"],
                          "plain_ms": cuda_time(lambda: quantize_blockwise8_plain(xl, dyn_t, 4096), n=3)["median"],
                          "bytes": n_l * 5 + n_l // 4096 * 4,
                          "bound_ms": bound_ms(n_l * 5 + n_l // 4096 * 4, 16 * n_l, PEAK_F32_FLOPS)[0],
                          "canary_bound_ms": (n_l * 5 + n_l // 4096 * 4) / canary_bs * 1e3},
              "sass_stl": sass_stl("quantize_blockwise8")})
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
    OTHER_CODEBOOKS = (("linear", torch.linspace(-1, 1, 256).numpy()),
                       ("dynamic_unsigned", create_dynamic_map(signed=False)), ("fp4", get_4bit_code("fp4", 64)))
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
        # kernel 13's other ranks: 256 linear entries (finer buckets), the
        # unsigned dynamic map (no bucket table fits: the binary search) and
        # fp4's 16 entries (unsorted: the linear count)
        for cname, cb in OTHER_CODEBOOKS:
            cb_t = tuple(float(v) for v in cb)
            for uu in (None, u):
                qk, ak = quantize_blockwise8(padded, cb, bbs, uu)
                qp, ap_ = quantize_blockwise8_plain(padded, cb_t, bbs, uu)
                assert torch.equal(qk, qp) and torch.equal(ak, ap_), \
                    f"quantize_blockwise8 {cname} bs{bbs} u={uu is not None}"
        cases.append(f"blockwise8 bs{bbs} n{n} zero-block stochastic f32/bf16/f16; linear, unsigned dynamic, fp4")
    # an input of more than two waves of kernel 13's full tiles (a small one takes one-run tiles)
    n = 9 << 20
    xb = torch.randn(n, generator=gen_q, device=dev)
    xb[4096:8192] = 0.0
    u = torch.rand(n, generator=gen_q, device=dev)
    for cname, cb in (("dynamic", dyn),) + OTHER_CODEBOOKS:
        cb_t = tuple(float(v) for v in cb)
        for uu in (None, u):
            qk, ak = quantize_blockwise8(xb, cb, 4096, uu)
            qp, ap_ = quantize_blockwise8_plain(xb, cb_t, 4096, uu)
            assert torch.equal(qk, qp) and torch.equal(ak, ap_), f"quantize_blockwise8 {cname} n{n} u={uu is not None}"
    cases.append(f"blockwise8 bs4096 n{n} full tiles: dynamic, linear, unsigned dynamic and fp4, both modes")
    del xb, u, qk, ak, qp, ap_
    emit("ragged_shapes_nested", passed=cases)

    # -- 3h. kernels 7 and 8: the backward g @ dequant(B) ------------------
    def nt_rel(out, ref):
        return ((out.float() - ref).abs().max() / ref.abs().max()).item()

    def nt_tol(dt):
        return 1e-5 if dt == torch.float32 else 1e-2

    cases = []
    for Mx, N, K, gbs in ((1, 2, 32, 32), (3, 18, 96, 32), (7, 64, 768, 32), (13, 130, 4160, 64),
                          (16, 256, 2176, 128), (31, 512, 4096, 256), (2, 4096, 14336, 64),
                          # a zero-padded second m16 tile (31), the grid over M tiles (33), two quant
                          # blocks a warp (bs 32), a quant block wider than the column tile (bs 512)
                          (31, 640, 2048, 64), (33, 640, 2048, 64), (9, 130, 4160, 32), (5, 256, 8192, 512)):
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
                if dt != torch.float32:  # the tensor-core kernel: a second call gives the same bits
                    again = (gemm_4bit_paired_nt_dq(Gx, *args, code, gbs, (N, K)) if compress
                             else gemm_4bit_paired_nt(Gx, qw.data, st.absmax, code, gbs, (N, K)))
                    assert torch.equal(out, again), f"nt {(Mx, N, K, gbs, compress, dt)}: a second call differs"
                cases.append(f"nt{'_dq' if compress else ''} M{Mx} N{N} K{K} bs{gbs} {str(dt)[6:]} rel {rel:.2e}")
    emit("ragged_shapes_backward", passed=cases)

    # The wrapper alone decides which kernel a call takes (PT._nt_uses_tc) and
    # passes it as tc; the C entry refuses a plan that kernel cannot take,
    # before it reads anything.
    Nr, Kr = 256, 640
    qw = QuantizedTensor.quantize(torch.randn(Nr, Kr, generator=gen, device=dev), blocksize=64)
    out_r = torch.empty(4, Kr, dtype=torch.float32, device=dev)
    part_r = torch.empty(8 * 4 * Kr, dtype=torch.float32, device=dev)
    refused = []
    for what, dt, gbs, rows, splits, tc, part in (
            ("f32 g on the tensor cores", torch.float32, 64, 256, 1, 1, None),
            ("blocksize 40 on the tensor cores", torch.bfloat16, 40, 256, 1, 1, None),
            ("rows_per_split 96 on the tensor cores", torch.bfloat16, 64, 96, 3, 1, part_r),
            ("two splits without partials", torch.bfloat16, 64, 128, 2, 1, None),
            ("the CUDA-core kernel without partials", torch.bfloat16, 64, 256, 1, 0, None)):
        Gr = torch.zeros(4, Nr, dtype=dt, device=dev)
        err = _lib.lib().bnb_gemm_4bit_paired_nt(
            Gr.data_ptr(), qw.data.data_ptr(), qw.state.absmax.data_ptr(), None if part is None else part.data_ptr(),
            out_r.data_ptr(), 4, Nr, Kr, gbs, rows, splits, tc, _lib.host_f32(units), PT._KIND[dt], _lib.stream(Gr))
        assert err != 0, f"nt: a mismatched plan was taken ({what})"
        refused.append(what)
    torch.cuda.synchronize()
    del qw, out_r, part_r
    emit("nt_mismatched_plans_refused", cases=refused)

    def nt_layer(compress):
        """Kernel 7 (or 8) on one layer's four linears transposed, M = 16:
        timed with and without the host in the window (hold=True), beside
        torch.matmul on the dequantized weight, each call against a second
        run bit for bit; kernel 7 also on an all-zero payload (every table
        load hits one word: no bank conflict)."""
        M = 16
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0, "ops": 0, "err": 0.0, "f16": 0.0,
               "device": 0.0, "lib_device": 0.0, "zero_payload": 0.0}
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
            lib = lambda: torch.matmul(Gx, Wb)  # noqa: E731
            out, ref = run(), plain()
            rel = nt_rel(out, ref)
            assert rel <= 1e-2, f"nt {name}: rel {rel}"
            assert torch.equal(run(), out), f"nt {name}: a second call differs"
            ms = cuda_time(run, flush_l2=True)["median"]
            pms = cuda_time(plain, n=3)["median"]
            lms = cuda_time(lib, flush_l2=True)["median"]
            dev_ms = cuda_time(run, flush_l2=True, hold=True)["median"]
            lib_dev = cuda_time(lib, flush_l2=True, hold=True)["median"]
            rows, splits = PT.nt_plan(M, N, K, sms)
            nbytes = M * N * 2 + N * K // 2 + sbytes + M * K * 2
            per_shape.append({"linear": name + "^T", "N": N, "K": K, "M": M, "ms": ms, "plain_ms": pms,
                              "library_ms": lms, "device_ms": dev_ms, "library_device_ms": lib_dev,
                              "splits": splits, "rows_per_split": rows, "bytes": nbytes,
                              "bound_ms": bound_ms(nbytes, 2 * M * N * K, PEAK_BF16_FLOPS)[0], "rel_err": rel})
            if not compress:
                Pz = torch.zeros_like(qw.data)
                tz = cuda_time(lambda: gemm_4bit_paired_nt(Gx, Pz, st.absmax, code, bs, (N, K)), flush_l2=True,
                               hold=True)["median"]
                per_shape[-1].update(zero_payload_device_ms=tz)
                tot["zero_payload"] += tz
                del Pz
            Gx = Gx.to(torch.float16)  # the same linear with f16 g
            assert nt_rel(run(), plain()) <= 1e-2, f"nt {name} f16"
            tot["f16"] += cuda_time(run, flush_l2=True)["median"]
            for key, v in (("ms", ms), ("plain", pms), ("lib", lms), ("bytes", nbytes), ("ops", 2 * M * N * K),
                           ("device", dev_ms), ("lib_device", lib_dev)):
                tot[key] += v
            tot["err"] = max(tot["err"], (out.float() - ref).abs().max().item())
            del qw, Wb, out, ref
        return tot, per_shape

    def nt_rows(compress):
        """Kernel 7 (or 8) on the four linears transposed at other M and with
        f16 g: two calls bit-identical, within nt_tol of the plain version,
        device time (host held out) summed over the layer."""
        sums = {}
        for name, (N, K) in LINEARS.items():
            qw = QuantizedTensor.quantize(torch.randn(N, K, generator=gen, device=dev) * K**-0.5, blocksize=bs,
                                          compress_statistics=compress)
            st = qw.state
            for Mx, dt in ((1, torch.bfloat16), (8, torch.bfloat16), (16, torch.float16), (31, torch.bfloat16),
                           (33, torch.bfloat16)):
                Gx = torch.randn(Mx, N, generator=gen, device=dev).to(dt)
                if compress:
                    args = (qw.data, st.absmax, st.state2.absmax, st.offset)
                    run = lambda: gemm_4bit_paired_nt_dq(Gx, *args, code, bs, (N, K))  # noqa: E731
                    ref = gemm_4bit_paired_nt_dq_plain(Gx, *args, units, bs)
                else:
                    run = lambda: gemm_4bit_paired_nt(Gx, qw.data, st.absmax, code, bs, (N, K))  # noqa: E731
                    ref = gemm_4bit_paired_nt_plain(Gx, qw.data, st.absmax, units, bs)
                o1 = run()
                assert torch.equal(o1, run()), f"nt {name} M{Mx}: a second call differs"
                rel = nt_rel(o1, ref)
                assert rel <= nt_tol(dt), f"nt {name} M{Mx} {dt}: rel {rel}"
                key = f"M{Mx}_{str(dt)[6:]}"
                sums[key] = sums.get(key, 0.0) + cuda_time(run, flush_l2=True, hold=True)["median"]
            del qw
        return sums

    sms = _sm_count(0)
    for name, compress in (("gemm_4bit_paired_nt", False), ("gemm_4bit_paired_nt_dq", True)):
        tot, per_shape = nt_layer(compress)
        extra = {}
        if not compress:
            extra = {"zero_payload_device_ms": tot["zero_payload"]}
            emit("k7_splits", sms=sms,
                 plan={p["linear"]: [p["rows_per_split"], p["splits"]] for p in per_shape})
        entry(name, tot["ms"], tot["plain"], tot["lib"], tot["bytes"], tot["ops"], PEAK_BF16_FLOPS, tot["err"],
              per_shape=per_shape, f16_g_ms=tot["f16"], device_ms=tot["device"],
              library_device_ms=tot["lib_device"], splits={p["linear"]: p["splits"] for p in per_shape},
              layer_device_ms_by_M=nt_rows(compress), **extra,
              note="sum over one layer's 4 linears transposed, M=16, bf16 g; library: "
                   "torch.matmul(g, W) on the dequantized bf16 weight; f16_g_ms: the same with f16 g; "
                   "device_ms, library_device_ms: the same two with the host held out of the window "
                   "(hold=True); layer_device_ms_by_M: device ms over the layer at other M and with f16 g"
                   + ("" if compress else "; zero_payload_device_ms: device ms on an all-zero payload "
                      "(every codebook load hits one word)"))
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
        g[min(7, n - 1)] = float("nan")
        if n > 600:
            g[600] = float("inf")
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

    # -- the grouped launch: one table of leaves a step, as 4d and 4f run it --
    # the 448 adapter tensors of 4d and 4f: rank 64 on seven targets of 32 layers
    lora_shapes = [tuple(t.shape) for t in L.lora_parameters(L.add_lora(
        cfg, rank=64, targets=LORA_TARGETS, generator=torch.Generator(device=dev).manual_seed(0), device=dev))
        if t.dim() > 0]
    assert len(lora_shapes) == 2 * len(LORA_TARGETS) * cfg.num_layers
    RAGGED = [(1,), (255,), (256,), (257,), (4099,), (2, 129), (14336, 64), (7,), (513,)]

    def group_inputs(name, shapes, dtype, zero_block, make):
        """One leaf per shape, as ``make`` draws them (flat), reshaped."""
        out = []
        for shp in shapes:
            t = make(name, math.prod(shp), zero_block and math.prod(shp) > 512, dtype)
            lead = (2,) if name == "ademamix" else ()
            out.append((t[0].reshape(shp), t[1].reshape(shp), t[2].reshape(lead + shp),
                        None if t[3] is None else t[3].reshape(shp), t[4], t[5]))
        return out

    def group_check(name, sc, shapes, dtype, zero_block, make, codes_x):
        """The grouped kernel over one table against the plain version leaf
        by leaf: parameters, states and absmax bit for bit."""
        leaves = group_inputs(name, shapes, dtype, zero_block, make)
        refs = [optimizer_update_8bit_plain(sc, *lf, q1_t, q2_t if sc.two_state else None, True) for lf in leaves]
        work = [tuple(None if t is None else t.clone() for t in lf) for lf in leaves]
        reset_launch_counts()
        optimizer_update_8bit_multi_(sc, work, codes_x)
        torch.cuda.synchronize()
        kname = "optimizer_update_8bit_ademamix" if sc.ademamix else "optimizer_update_8bit"
        assert launch_counts()[kname] == 1, f"{name}: {launch_counts()}"
        for i, (w, r) in enumerate(zip(work, refs)):
            for k, rr, what in zip(w[1:], r, ("param", "state1", "state2", "absmax1", "absmax2")):
                assert (k is None) == (rr is None), what
                if k is not None:
                    assert torch.equal(k.reshape(-1).view(torch.uint8), rr.reshape(-1).contiguous().view(torch.uint8)), \
                        f"grouped {name} {dtype} leaf {i} {tuple(shapes[i])}: {what} differs"
        return {"rule": name, "leaves": len(shapes), "dtype": str(dtype)[6:], "bit_identical": True}

    def group_bytes(shapes, states, elem):
        n = sum(math.prod(sh) for sh in shapes)
        nb = sum(-(-math.prod(sh) // 256) for sh in shapes)
        return n * 3 * elem + states * (2 * n + 8 * nb), n

    def group_time(name, sc, shapes, make, codes_x, states, ops_per_el):
        """One grouped step over ``shapes`` (f32) through the optimizer's
        entry: device time with the host held out by a spin of about 11 ms
        (its host time, the table built, pinned and sent and the launch, must
        fit inside it), the time with the host in the window, and the plain
        version leaf by leaf."""
        leaves = group_inputs(name, shapes, torch.float32, False, make)
        st = [StateLeaf(sc.rule, *lf[1:]) for lf in leaves]
        gs = [lf[0] for lf in leaves]
        held = cuda_time(lambda: optimizer_update_leaves_(sc, gs, st, codes_x), flush_l2=True, hold=True,
                         hold_cycles=20_000_000)
        assert held["host_ms"] < held["spin_ms"], f"{name}: the host took {held['host_ms']} ms, the spin less"
        full_ms = cuda_time(lambda: optimizer_update_leaves_(sc, gs, st, codes_x), flush_l2=True)["median"]
        plain_ms = cuda_time(lambda: [optimizer_update_8bit_plain(sc, *lf, q1_t, q2_t if sc.two_state else None, True)
                                      for lf in leaves], n=3, warmup=1)["median"]
        nbytes, n = group_bytes(shapes, states, 4)
        return {"leaves": len(shapes), "n": n, "device_ms": held["median"], "ms_with_host": full_ms,
                "call_host_ms": held["host_ms"], "spin_ms": held["spin_ms"], "plain_ms": plain_ms, "bytes": nbytes,
                "bound_ms": bound_ms(nbytes, ops_per_el * n, PEAK_F32_FLOPS)[0],
                "canary_bound_ms": nbytes / canary_bs * 1e3}

    def leaf_device_ms(name, sc, n, make, codes_x):
        g, p, s1, s2, am1, am2 = make(name, n, False, torch.float32)
        return cuda_time(lambda: optimizer_update_8bit_(sc, g, p, s1, s2, am1, am2, codes_x), flush_l2=True,
                         hold=True)["median"]

    sc14 = UpdateScalars.make("adam", beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-2, step=5, lr=1e-3)
    group_cases = [group_check("adam", sc14, lora_shapes, torch.float32, False, opt_inputs, codes2)]
    torch.cuda.empty_cache()
    for name in hyper:
        b1, b2, eps, wd, lr = hyper[name]
        for step in (1, 5):
            sc = UpdateScalars.make(name, beta1=b1, beta2=b2, eps=eps, weight_decay=wd, step=step, lr=lr)
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                group_cases.append(group_check(name, sc, RAGGED, dt, step == 1, opt_inputs,
                                               codes2 if name in ("adam", "lamb") else codes1))
    grouped = group_time("adam", sc14, lora_shapes, opt_inputs, codes2, 2, 25)
    torch.cuda.empty_cache()
    for leaf_t, n in ((lora_leaf, 14336 * 64), (big_leaf, 64 << 20)):
        leaf_t["device_ms"] = leaf_device_ms("adam", sc14, n, opt_inputs, codes2)
        leaf_t["canary_bound_ms"] = leaf_t["bytes"] / canary_bs * 1e3
    torch.cuda.empty_cache()
    entry("optimizer_update_8bit", grouped["device_ms"], grouped["plain_ms"], None, grouped["bytes"], 25 * grouped["n"],
          PEAK_F32_FLOPS, 0.0, shape=f"the 448 adapter tensors of 4d in one launch, {grouped['n']} elements",
          rule="adamw, step 5", grouped_step=grouped, cases=checks, grouped_cases=group_cases,
          leaf_14336x64=lora_leaf, leaf_64M=big_leaf, bf16_params=lora_leaf_bf16,
          adamw_fused_f32_ms=lora_leaf["adamw_fused_f32_ms"], sass_has_stl=sass_stl("optimizer_update_8bit"),
          note="ms: one grouped step's device time, the host held out (grouped_step: ms_with_host holds it "
               "in, call_host_ms is its host time). library_ms is null: no PyTorch call keeps 8-bit states; "
               "adamw_fused_f32_ms is torch.optim.AdamW(fused=True) on f32 states of one [14336, 64] tensor, "
               "a different function")

    # -- 3j. the backward thresholds: kernels 7 and 8 against kernels 3 and 6 + matmul, device time, by g's type
    sweep, crossover = [], {}
    for name in ("gate_up", "down"):
        N, K = LINEARS[name]
        qw = QuantizedTensor.quantize(torch.randn(N, K, generator=gen, device=dev) * K**-0.5, blocksize=bs,
                                      compress_statistics=True)
        st = qw.state
        P, am_t, dq = qw.data, st.dequant_absmax_t(), (st.absmax, st.state2.absmax, st.offset)
        for dname, Mx in BACKWARD_SWEEP:
            dt = getattr(torch, dname)
            Gx = torch.randn(Mx, N, generator=gen, device=dev).to(dt)
            t = {key: cuda_time(fn, **backward_reps(dt, Mx))["median"] for key, fn in (
                ("nt_kernel_ms", lambda: gemm_4bit_paired_nt(Gx, P, am_t, code, bs, (N, K))),
                ("dequant_matmul_ms", lambda: torch.matmul(Gx, dequantize_paired_fast(P, am_t, code, bs, dt))),
                ("nt_dq_kernel_ms", lambda: gemm_4bit_paired_nt_dq(Gx, P, *dq, code, bs, (N, K))),
                ("dequant_dq_matmul_ms", lambda: torch.matmul(Gx, dequantize_paired_fast_dq(P, *dq, code, bs, dt))))}
            sweep.append({"linear": name + "^T", "dtype": dname, "M": Mx, **t})
            for inst, k, r in (("plain", "nt_kernel_ms", "dequant_matmul_ms"),
                               ("nested", "nt_dq_kernel_ms", "dequant_dq_matmul_ms")):
                key = f"{name}^T_{dname}_{inst}"
                if t[k] > t[r] and key not in crossover:
                    crossover[key] = Mx  # the first M at which kernel 7 (8) trails
            del Gx
        del qw, am_t, dq
    emit("backward_threshold_sweep", BACKWARD_LARGE_M_THRESHOLD=G.BACKWARD_LARGE_M_THRESHOLD,
         BACKWARD_F16_LARGE_M_THRESHOLD=G.BACKWARD_F16_LARGE_M_THRESHOLD,
         BACKWARD_F32_LARGE_M_THRESHOLD=G.BACKWARD_F32_LARGE_M_THRESHOLD,
         first_M_kernel7_trails=crossover, points=sweep)
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

    def kadj_nested(qt):
        """The _dq kernels' scale arguments of a nested flat/2d state: u8 codes, s2, offset."""
        return qt.state.absmax.reshape(-1), qt.state.state2.absmax, qt.state.offset

    def rel_err(out, ref):
        return ((out.float() - ref).abs().max() / ref.abs().max()).item()

    # kernel 9 on the tensor cores at M 1-40 (one to four n8 tiles, then the grid
    # over M), N not a multiple of 16, blocksize 32-4096, most cut into splits of K
    tc_cases = tuple((Mx, 77 + 40 * i, max(2048, 2 * gbs), gbs)
                     for i, gbs in enumerate((32, 64, 128, 256, 4096)) for Mx in (1, 8, 16, 31, 33, 40))
    cases, k9_err, k11_err = [], 0.0, 0.0
    for Mx, N, K, gbs in ((1, 3, 32, 32), (3, 37, 96, 32), (7, 129, 4160, 64), (13, 255, 2176, 128),
                          (31, 513, 4096, 256), (5, 64, 8192, 4096), (2, 77, 14336, 512), (9, 31, 2048, 1024),
                          (4, 17, 4096, 2048), (16, 4096, 14336, 64),
                          # kernel 11: a zero-padded second m16 tile (31), the grid over M tiles (33)
                          (31, 640, 2048, 64), (33, 640, 2048, 64), (33, 37, 96, 32)) + tc_cases:
        for compress in (False, True):
            qw = QuantizedTensor.quantize(torch.randn(N, K, generator=gen, device=dev), blocksize=gbs,
                                          compress_statistics=compress, quant_storage=torch.bfloat16)
            assert qw.state.layout == "2d" and qw.data.dtype == torch.uint16
            assert qw.state.inline_nested == compress
            Bq, am = kadj(qw)
            ct = tuple(float(v) for v in get_4bit_code("nf4", gbs))
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                Wk = dequantize_4bit_2d(Bq, am, code, gbs, (N, K), dt)
                assert torch.equal(Wk.view(torch.uint8), dequantize_4bit_2d_plain(Bq, am, ct, gbs, (N, K), dt).view(
                    torch.uint8)), f"dequantize_4bit_2d {(N, K, gbs, dt)}"
                assert bits_equal(Wk, dequantize_4bit_2d(Bq, am, code, gbs, (N, K), dt)), "kernel 10: a second call"
                A = torch.randn(Mx, K, generator=gen, device=dev).to(dt)
                out = gemm_4bit_fused(A, Bq, am, code, gbs, (N, K), out_dtype=torch.float32)
                ref = gemm_4bit_fused_plain(A, Bq, am, ct, gbs, N)
                rel = rel_err(out, ref)
                assert rel <= 1e-5, f"gemm_4bit_fused {(Mx, N, K, gbs, compress, dt)}: rel {rel}"
                o_dt = gemm_4bit_fused(A, Bq, am, code, gbs, (N, K))
                assert torch.equal(o_dt, out.to(dt)), "kernel 9 in A's type"
                assert torch.equal(gemm_4bit_fused(A, Bq, am, code, gbs, (N, K)), o_dt), "kernel 9: a second call"
                if compress:  # the nested instances on the codes: the plain ones' bits on the resolved absmax
                    nest = kadj_nested(qw)
                    assert torch.equal(gemm_4bit_fused_dq(A, Bq, *nest, code, gbs, (N, K), out_dtype=torch.float32),
                                       out), f"gemm_4bit_fused_dq {(Mx, N, K, gbs, dt)}"
                    assert torch.equal(gemm_4bit_fused_dq(A, Bq, *nest, code, gbs, (N, K)), o_dt), "k9 dq in A's type"
                    W_dq = dequantize_4bit_2d_dq(Bq, *nest, code, gbs, (N, K), dt)
                    assert bits_equal(W_dq, Wk), f"dequantize_4bit_2d_dq {(N, K, gbs, dt)}"
                    assert bits_equal(W_dq, dequantize_4bit_2d_dq(Bq, *nest, code, gbs, (N, K), dt)), \
                        "kernel 10 dq: a second call"
                Gx = torch.randn(Mx, N, generator=gen, device=dev).to(dt)
                o11 = gemm_4bit_nt_fused(Gx, Bq, am, code, gbs, (N, K))
                rel11 = rel_err(o11, gemm_4bit_nt_fused_plain(Gx, Bq, am, ct, gbs, K))
                assert o11.dtype == dt and rel11 <= nt_tol(dt), f"gemm_4bit_nt_fused {(Mx, N, K, gbs, dt)}: {rel11}"
                k9_err, k11_err = max(k9_err, rel), max(k11_err, rel11 if dt == torch.float32 else 0.0)
            cases.append(f"k9/k10/k11 M{Mx} N{N} K{K} bs{gbs} nested={compress} f32/bf16/f16 "
                         f"splits {K9._gemm2d_plan(Mx, N, K, gbs, sms)[1]}")
    for shape, fbs in (((7, 77), 64), ((1, 4099), 32)):  # flat layouts, blocks across rows, an odd count
        for compress in (False, True):
            qw = QuantizedTensor.quantize(torch.randn(*shape, generator=gen, device=dev), blocksize=fbs,
                                          compress_statistics=compress)
            assert qw.state.layout == "flat"
            ct = tuple(float(v) for v in get_4bit_code("nf4", fbs))
            Bq, am = kadj(qw)
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                W = dequantize_4bit_2d_plain(Bq, am, ct, fbs, shape, dt)
                assert torch.equal(qw.dequantize().to(dt), W), f"flat {shape}"
                for _ in range(2):  # each call, and a second one
                    assert bits_equal(dequantize_4bit_2d(Bq, am, code, fbs, shape, dt), W), f"flat {shape} {dt}"
                    if compress:
                        assert bits_equal(dequantize_4bit_2d_dq(Bq, *kadj_nested(qw), code, fbs, shape, dt), W), \
                            f"flat dq {shape} {dt}"
            cases.append(f"k10 flat {shape} bs{fbs} nested={compress}")
    code_t9 = tuple(float(v) for v in code)
    # blocksizes the quantizer does not make (96, 160: blocks that straddle
    # the 256-column stages), on scales made by hand: each _dq mode against
    # its plain mode on the decoded absmax, bit for bit
    gen_c = torch.Generator().manual_seed(11)
    for Mx, N, K, gbs in ((8, 77, 96 * 24, 96), (33, 130, 160 * 9, 160), (1, 40, 96 * 3, 96)):
        Bq = torch.randint(0, 256, (N * K // 2,), dtype=torch.uint8, generator=gen_c).to(dev)
        nb = N * K // gbs
        nest = (torch.randint(0, 256, (nb,), dtype=torch.uint8, generator=gen_c).to(dev),
                torch.rand(-(-nb // 256), generator=gen_c).to(dev) + 0.5, torch.full((1,), 0.25, device=dev))
        am = K9.nested_absmax(*nest)
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            A = torch.randn(Mx, K, generator=gen, device=dev).to(dt)
            out = gemm_4bit_fused_dq(A, Bq, *nest, code, gbs, (N, K), out_dtype=torch.float32)
            assert torch.equal(out, gemm_4bit_fused(A, Bq, am, code, gbs, (N, K), out_dtype=torch.float32)), \
                f"gemm_4bit_fused_dq bs{gbs} {dt}"
            rel = rel_err(out, gemm_4bit_fused_plain(A, Bq, am, code_t9, gbs, N))
            assert rel <= 1e-5, f"gemm_4bit_fused_dq bs{gbs} {dt}: rel {rel}"
            assert torch.equal(dequantize_4bit_2d_dq(Bq, *nest, code, gbs, (N, K), dt),
                               dequantize_4bit_2d(Bq, am, code, gbs, (N, K), dt)), f"dequantize_4bit_2d_dq bs{gbs}"
            k9_err = max(k9_err, rel)
        cases.append(f"k9/k10 dq M{Mx} N{N} K{K} bs{gbs} (scales made by hand) bf16/f16/f32 "
                     f"splits {K9._gemm2d_plan(Mx, N, K, gbs, sms)[1]}")
    # kernel 10's tile edges (csrc/gemm4bit.cu: 16384 flat elements a block):
    # one tile, a tile +- 8 elements, odd counts (the last byte holds one
    # element), a 2-D shape whose blocks run across rows; blocksizes 16 (1025
    # scale slots a tile), 48 and 96 (a tile starts inside a block) and 4096
    # (a slot a tile or less); payloads and nested scales made by hand.  Each
    # mode bit for bit against its plain version and a second call, _dq
    # against the plain mode on the decoded absmax, in bf16, f16 and f32.
    tile = 16384
    for shape in ((tile,), (tile - 8,), (tile + 8,), (tile + 5,), (4 * tile + 3,), (3, 5463), (1,), (9,)):
        n_el = math.prod(shape)
        for gbs in (16, 48, 96, 4096):
            Bq = torch.randint(0, 256, ((n_el + 1) // 2,), dtype=torch.uint8, generator=gen_c).to(dev)
            nb = -(-n_el // gbs)
            am = (torch.rand(nb, generator=gen_c) * 3 + 0.01).to(dev)
            nest = (torch.randint(0, 256, (nb,), dtype=torch.uint8, generator=gen_c).to(dev),
                    torch.rand(-(-nb // 256), generator=gen_c).to(dev) + 0.5, torch.full((1,), 0.25, device=dev))
            am_n = K9.nested_absmax(*nest)
            code_e = get_4bit_code("nf4", gbs)
            ct = tuple(float(v) for v in code_e)
            for dt in (torch.bfloat16, torch.float16, torch.float32):
                for what, fn, plain_fn, scales in (
                        ("dequantize_4bit_2d", dequantize_4bit_2d, dequantize_4bit_2d_plain, (am,)),
                        ("dequantize_4bit_2d_dq", dequantize_4bit_2d_dq, dequantize_4bit_2d_dq_plain, nest)):
                    Wk = fn(Bq, *scales, code_e, gbs, shape, dt)
                    assert bits_equal(Wk, plain_fn(Bq, *scales, ct, gbs, shape, dt)), f"{what} {shape} bs{gbs} {dt}"
                    assert bits_equal(Wk, fn(Bq, *scales, code_e, gbs, shape, dt)), f"{what}: a second call"
                assert bits_equal(Wk, dequantize_4bit_2d(Bq, am_n, code_e, gbs, shape, dt)), \
                    f"dequantize_4bit_2d_dq {shape} bs{gbs} {dt}: not the plain mode's bits on the decoded absmax"
        cases.append(f"k10 tile edge {shape} bs16/48/96/4096 plain/dq bf16/f16/f32")
    emit("ragged_shapes_kadjacent", passed=cases, k9_max_rel=k9_err, k11_max_rel_f32=k11_err)

    # The wrapper alone decides which kernel a call takes (K9._gemm2d_uses_tc)
    # and passes it as tc with the plan; the C entries refuse a plan that
    # kernel cannot take, before they read anything.
    Nr, Kr = 256, 1024
    qw = QuantizedTensor.quantize(torch.randn(Nr, Kr, generator=gen, device=dev), blocksize=64,
                                  compress_statistics=True, quant_storage=torch.bfloat16)
    Br, am_r = kadj(qw)
    out_r = torch.empty(4, Nr, dtype=torch.float32, device=dev)
    part_r = torch.empty(16 * 4 * Nr, dtype=torch.float32, device=dev)
    refused = []
    for what, dt, gbs, Kx, kps, splits, tc, part in (
            ("f32 A on the tensor cores", torch.float32, 64, Kr, 1024, 1, 1, None),
            ("bf16 A on the CUDA cores", torch.bfloat16, 64, Kr, 1024, 1, 0, None),
            ("blocksize 48", torch.bfloat16, 48, 1056, 1056, 1, 1, None),
            ("splits of part of a quantization block", torch.bfloat16, 256, Kr, 384, 3, 1, part_r),
            ("splits of part of a stage", torch.bfloat16, 32, Kr, 96, 11, 1, part_r),
            ("two splits without partials", torch.bfloat16, 64, Kr, 512, 2, 1, None),
            ("splits short of K", torch.bfloat16, 64, Kr, 256, 2, 1, part_r),
            ("an empty split", torch.bfloat16, 64, Kr, 512, 3, 1, part_r),
            ("f32 A split on the CUDA cores", torch.float32, 64, Kr, 512, 2, 0, part_r)):
        Ar = torch.zeros(4, Kr, dtype=dt, device=dev)
        err = _lib.lib().bnb_gemm_4bit_fused(
            Ar.data_ptr(), Br.data_ptr(), am_r.data_ptr(), None if part is None else part.data_ptr(),
            out_r.data_ptr(), 4, Nr, Kx, gbs, kps, splits, tc, _lib.host_f32(code), PT._KIND[dt], 1, _lib.stream(Ar))
        assert err != 0, f"kernel 9: a mismatched plan was taken ({what})"
        refused.append(what)
    Ar = torch.zeros(4, Kr, dtype=torch.bfloat16, device=dev)
    cr, s2r, offr = kadj_nested(qw)
    err = _lib.lib().bnb_gemm_4bit_fused_dq(
        Ar.data_ptr(), Br.data_ptr(), cr.data_ptr(), s2r.data_ptr(), offr.data_ptr(), None, out_r.data_ptr(), 4, Nr,
        Kr, 64, 512, 2, 1, _lib.host_f32(code), ctypes.addressof(PT._dyn_decode()), PT._KIND[torch.bfloat16], 1,
        _lib.stream(Ar))
    assert err != 0, "kernel 9 dq: a mismatched plan was taken (two splits without partials)"
    refused.append("kernel 9 dq: two splits without partials")
    torch.cuda.synchronize()
    del qw, Br, am_r, out_r, part_r
    emit("kernel9_mismatched_plans_refused", cases=refused)

    kq, kp = {}, {}  # the four linears on the K-adjacent layout, nested, and the same weights paired (kernel 3's)
    for name, (N, K) in LINEARS.items():
        Wf = torch.randn(N, K, generator=gen, device=dev) * K**-0.5
        kq[name] = QuantizedTensor.quantize(Wf, blocksize=bs, compress_statistics=True, quant_storage=torch.bfloat16)
        kp[name] = QuantizedTensor.quantize(Wf, blocksize=bs)
        del Wf
    code_t = tuple(float(v) for v in code)

    def kadj_scale_bytes(N, K, nested):
        """The scales' bytes: the f32 absmax, or the u8 codes, s2 and the offset."""
        KB = K // bs
        return KB * N + -(-N * KB // 256) * 4 + 4 if nested else KB * N * 4

    def kadj_bytes(M, N, K, nested, backward=False):
        """A call's bytes: activations in and out (bf16), the payload, the scales."""
        return M * (N if backward else K) * 2 + N * K // 2 + kadj_scale_bytes(N, K, nested) + M * (
            K if backward else N) * 2

    def k9_call(qt, X, nested, out_dtype=None):
        """Kernel 9 on a nested state: its _dq instance on the codes, or its
        plain instance on the absmax resolved beforehand."""
        N, K = qt.state.shape
        Bq = payload_bytes(qt.data).reshape(-1)
        if nested:
            nest = kadj_nested(qt)
            return lambda: gemm_4bit_fused_dq(X, Bq, *nest, code, bs, (N, K), out_dtype=out_dtype)
        am = qt.state.dequant_absmax().contiguous()
        return lambda: gemm_4bit_fused(X, Bq, am, code, bs, (N, K), out_dtype=out_dtype)

    def kadj_layer(M, variant):
        """Kernel 9 (plain on the resolved absmax, or nested) or 11 (transposed,
        on the resolved absmax: the path's small-M backward) on one layer's
        four linears, bf16 operands.  Also timed with the host held out of the
        window, as the matmul beside it; kernel 11 shows its split plan, and
        kernel 9's nested instance the plain one's bits."""
        backward, nested = variant == "k11", variant == "k9_dq"
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "decode": 0.0, "bytes": 0, "ops": 0, "err": 0.0,
               "device": 0.0, "lib_device": 0.0}
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
                out = run()
            else:
                X = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                if nested:
                    plain = lambda: gemm_4bit_fused_dq_plain(X, Bq, *kadj_nested(qt), code_t, bs, N)  # noqa: E731
                else:
                    plain = lambda: gemm_4bit_fused_plain(X, Bq, am, code_t, bs, N)  # noqa: E731
                lib = lambda: torch.matmul(X, Wb.t())  # noqa: E731
                out = k9_call(qt, X, nested, torch.float32)()
                run = k9_call(qt, X, nested)
                if nested:
                    assert torch.equal(out, k9_call(qt, X, False, torch.float32)()), f"k9 dq {name}: not k9's bits"
            ref = plain()
            rel = rel_err(out, ref)
            assert rel <= (1e-2 if backward else 1e-5), f"{variant} {name}: rel {rel}"
            ms = cuda_time(run, flush_l2=True)["median"]
            pms = cuda_time(plain, n=3)["median"]
            lms = cuda_time(lib, flush_l2=True)["median"]
            dms = cuda_time(qt.state.dequant_absmax, n=5)["median"] if backward else 0.0
            nbytes = kadj_bytes(M, N, K, nested, backward)
            per_shape.append({"linear": name + ("^T" if backward else ""), "N": N, "K": K, "M": M, "ms": ms,
                              "plain_ms": pms, "library_ms": lms, "bytes": nbytes,
                              "bound_ms": bound_ms(nbytes, 2 * M * N * K, PEAK_BF16_FLOPS)[0], "rel_err": rel})
            if backward:
                per_shape[-1]["nested_decode_ms"] = dms
            dev_ms = cuda_time(run, flush_l2=True, hold=True)["median"]
            lib_dev = cuda_time(lib, flush_l2=True, hold=True)["median"]
            per_shape[-1].update(device_ms=dev_ms, library_device_ms=lib_dev)
            tot["device"] += dev_ms
            tot["lib_device"] += lib_dev
            assert torch.equal(run(), run()), f"{variant} {name}: a second call differs"
            if backward:
                rows, splits = nt_plan(M, N, K, sms)
                per_shape[-1].update(splits=splits, rows_per_split=rows)
            else:
                per_shape[-1]["splits"] = K9._gemm2d_plan(M, N, K, bs, sms)[1]
            for key, v in (("ms", ms), ("plain", pms), ("lib", lms), ("decode", dms), ("bytes", nbytes),
                           ("ops", 2 * M * N * K)):
                tot[key] += v
            tot["err"] = max(tot["err"], (out.float() - ref).abs().max().item())
            del Wb, out, ref
        return tot, per_shape

    def k11_rows():
        """Kernel 11 on the four linears transposed at other M and with f16 g:
        two calls bit-identical, within nt_tol of the plain version, device
        time (host held out) summed over the layer."""
        sums = {}
        for name, (N, K) in LINEARS.items():
            Bq, am = kadj(kq[name])
            for Mx, dt in ((1, torch.bfloat16), (8, torch.bfloat16), (16, torch.float16), (31, torch.bfloat16),
                           (33, torch.bfloat16)):
                Gx = torch.randn(Mx, N, generator=gen, device=dev).to(dt)
                run = lambda: gemm_4bit_nt_fused(Gx, Bq, am, code, bs, (N, K))  # noqa: E731
                o1 = run()
                assert torch.equal(o1, run()), f"k11 {name} M{Mx}: a second call differs"
                rel = rel_err(o1, gemm_4bit_nt_fused_plain(Gx, Bq, am, code_t, bs, K))
                assert rel <= nt_tol(dt), f"k11 {name} M{Mx} {dt}: rel {rel}"
                key = f"M{Mx}_{str(dt)[6:]}"
                sums[key] = sums.get(key, 0.0) + cuda_time(run, flush_l2=True, hold=True)["median"]
        return sums

    def k9_rows(nested):
        """Kernel 9 on the four linears at M 8 and 16 with bf16 and f16 A:
        two calls bit-identical, within 1e-2 of the plain version, device time
        (host held out) summed over the layer."""
        sums = {}
        for name, (N, K) in LINEARS.items():
            Bq, am = kadj(kq[name])
            for Mx in (8, 16):
                for dt in (torch.bfloat16, torch.float16):
                    X = torch.randn(Mx, K, generator=gen, device=dev).to(dt)
                    run = k9_call(kq[name], X, nested)
                    o1 = run()
                    assert torch.equal(o1, run()), f"k9 {name} M{Mx}: a second call differs"
                    rel = rel_err(o1, gemm_4bit_fused_plain(X, Bq, am, code_t, bs, N))
                    assert rel <= 1e-2, f"k9 {name} M{Mx} {dt}: rel {rel}"
                    key = f"M{Mx}_{str(dt)[6:]}"
                    sums[key] = sums.get(key, 0.0) + cuda_time(run, flush_l2=True, hold=True)["median"]
        return sums

    for name, variant, M in (("gemm_4bit_fused", "k9", 8), ("gemm_4bit_fused_dq", "k9_dq", 8),
                             ("gemm_4bit_nt_fused", "k11", 16)):
        backward = variant == "k11"
        tot, per_shape = kadj_layer(M, variant)
        extra = {"device_ms": tot["device"], "library_device_ms": tot["lib_device"],
                 "splits": {p["linear"]: p["splits"] for p in per_shape}}
        if backward:
            extra.update(layer_device_ms_by_M=k11_rows(), nested_decode_ms=tot["decode"])
            emit("k11_splits", sms=sms, plan={p["linear"]: [p["rows_per_split"], p["splits"]] for p in per_shape})
        else:
            extra.update(layer_device_ms_by_M=k9_rows(variant == "k9_dq"))
        entry(name, tot["ms"], tot["plain"], tot["lib"], tot["bytes"], tot["ops"], PEAK_BF16_FLOPS, tot["err"],
              per_shape=per_shape, **extra,
              note=f"sum over one layer's 4 linears{' transposed' if backward else ''} at M={M}, bf16 "
                   f"{'g' if backward else 'A'}, bf16 quant_storage, "
                   + ("the nested absmax decoded to f32 beforehand (nested_decode_ms: that decode, the path's "
                      "per-call cost, timed apart)" if backward else
                      "the nested absmax decoded in the kernel (_dq)" if variant == "k9_dq" else
                      "on the nested absmax resolved to f32 beforehand")
                   + "; library: torch.matmul on the dequantized bf16 weight; device_ms, library_device_ms: the "
                     "same two with the host held out of the window (hold=True); layer_device_ms_by_M: the "
                     "kernel's device ms over the layer at other M and dtypes")

    # kernel 11 with splits > 1 bit for bit its plain version: on wo^T's
    # shape, g of 512 entries +-1 a row (the rest 0) and every absmax 1, so
    # W is the codebook in g's type and every f32 partial sum, in any order
    # and split, is exact; partials that changed under the kernel (a buffer
    # handed out again while it writes) would show.  Two calls each.
    Ne, Ke = LINEARS["wo"]
    gen_e = torch.Generator().manual_seed(21)
    Be = torch.randint(0, 256, (Ne * Ke // 2,), dtype=torch.uint8, generator=gen_e).to(dev)
    ame = torch.ones(Ne * Ke // bs, device=dev)
    k11_exact = {}
    for Mx in (16, 33):
        rows_e, splits_e = nt_plan(Mx, Ne, Ke, sms)
        assert splits_e > 1, f"k11 exact: M {Mx} takes {splits_e} split"
        idx = torch.rand(Mx, Ne, generator=gen_e).argsort(dim=1)[:, :512]
        sign = (torch.randint(0, 2, (Mx, 512), generator=gen_e) * 2 - 1).float()
        G0 = torch.zeros(Mx, Ne).scatter_(1, idx, sign)
        for dt in (torch.bfloat16, torch.float16):
            Gx = G0.to(dev, dt)
            ref = gemm_4bit_nt_fused_plain(Gx, Be, ame, code_t, bs, Ke).to(dt)
            for _ in range(2):
                assert bits_equal(gemm_4bit_nt_fused(Gx, Be, ame, code, bs, (Ne, Ke)), ref), \
                    f"k11 M {Mx} {dt}, {splits_e} splits: not its plain version's bits"
            k11_exact[f"M{Mx}_{str(dt)[6:]}"] = {"splits": splits_e, "rows_per_split": rows_e}
    emit("k11_splits_bit_exact", shape=[Ne, Ke], cases=k11_exact)
    del Be, ame

    # kernel 10 at the four linears in bf16, f16 and f32, plain (on the
    # resolved absmax) and _dq (against the plain mode's bits), beside the
    # store floor and kernel 3 on the same weights in the paired layout
    resolved10 = {name: kadj(kq[name]) for name in LINEARS}

    def k10(name, dt):
        return dequantize_4bit_2d(*resolved10[name], code, bs, LINEARS[name], dt)

    def k10_dq(name, dt):
        return dequantize_4bit_2d_dq(resolved10[name][0], *kadj_nested(kq[name]), code, bs, LINEARS[name], dt)

    layer10 = {
        False: dequant_layer(
            k10, lambda name, dt: dequantize_4bit_2d_plain(*resolved10[name], code_t, bs, LINEARS[name], dt),
            lambda name: kadj_scale_bytes(*LINEARS[name], False),
            beside={"kernel3": lambda name, dt: dequantize_paired_fast(kp[name].data, kp[name].state.absmax, code, bs,
                                                                       dt)}),
        True: dequant_layer(
            k10_dq, lambda name, dt: dequantize_4bit_2d_dq_plain(resolved10[name][0], *kadj_nested(kq[name]), code_t,
                                                                 bs, LINEARS[name], dt),
            lambda name: kadj_scale_bytes(*LINEARS[name], True), resolved=k10, resolved_key="kernel10_resolved")}
    del kp
    N, K = LINEARS["gate_up"]
    Bq, am = resolved10["gate_up"]
    nest = kadj_nested(kq["gate_up"])
    for name, run, plain, nested in (
            ("dequantize_4bit_2d", lambda: dequantize_4bit_2d(Bq, am, code, bs, (N, K)),
             lambda: dequantize_4bit_2d_plain(Bq, am, code_t, bs, (N, K), torch.bfloat16), False),
            ("dequantize_4bit_2d_dq", lambda: dequantize_4bit_2d_dq(Bq, *nest, code, bs, (N, K)),
             lambda: dequantize_4bit_2d_dq_plain(Bq, *nest, code_t, bs, (N, K), torch.bfloat16), True)):
        layer = layer10[nested]
        entry(name, cuda_time(run, flush_l2=True)["median"], cuda_time(plain, n=3)["median"], None,
              kadj_bytes(0, N, K, nested) + N * K * 2, N * K, PEAK_F32_FLOPS, 0.0, shape=[N, K], dtype="bfloat16",
              device_ms=layer["per_linear"]["gate_up"]["bfloat16"]["device_ms"], **layer,
              note="ms: gate_up to bf16 with the host in the window; device_ms the same held out (hold=True); "
                   + ("the nested absmax decoded in the kernel; layer_kernel10_resolved_device_ms: the plain mode on "
                      "the resolved absmax" if nested else "on the nested absmax resolved to f32 beforehand; "
                      "layer_kernel3_device_ms: kernel 3 on the same weights in the paired layout")
                   + "; layer_device_ms: the four linears, each output type; store_floor_ms: zero_() of the same W")
    del resolved10

    # The route sweep that sets the K-adjacent forward thresholds, device time
    # with the host held out: kernel 9 (plain and nested) against kernel 10
    # (plain and _dq) + matmul in A's type, bf16, f16 and f32 A; then kernel
    # 11 against kernel 10 + matmul^T with bf16 g (the backward threshold).
    def dev_t(f):
        return cuda_time(f, n=10, flush_l2=True, hold=True)["median"]

    sweep, crossover, crossover_bw = [], {}, {}
    for name in ("gate_up", "down"):
        N, K = LINEARS[name]
        qt = kq[name]
        Bq, am = kadj(qt)
        nest = kadj_nested(qt)
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            for Mx in (8, 16, 24, 32, 48, 64, 65, 96, 128, 160, 192, 256):
                A = torch.randn(Mx, K, generator=gen, device=dev).to(dt)
                pt = {"linear": name, "dtype": str(dt)[6:], "M": Mx,
                      "k9_ms": dev_t(lambda: gemm_4bit_fused(A, Bq, am, code, bs, (N, K))),
                      "k9_dq_ms": dev_t(lambda: gemm_4bit_fused_dq(A, Bq, *nest, code, bs, (N, K))),
                      "k10_matmul_ms": dev_t(lambda: torch.matmul(A, dequantize_4bit_2d(Bq, am, code, bs, (N, K),
                                                                                        dt).t())),
                      "k10_dq_matmul_ms": dev_t(lambda: torch.matmul(A, dequantize_4bit_2d_dq(
                          Bq, *nest, code, bs, (N, K), dt).t()))}
                sweep.append(pt)
                for inst, k, r in (("plain", "k9_ms", "k10_matmul_ms"), ("nested", "k9_dq_ms", "k10_dq_matmul_ms")):
                    key = f"{name}_{pt['dtype']}_{inst}"
                    if pt[k] > pt[r] and key not in crossover:
                        crossover[key] = Mx  # the first M at which kernel 9 trails
        # the nested state's small-M route decodes its absmax first (kernel 11
        # takes f32 scales): k11_with_decode_ms holds that decode
        for dname, Mx in BACKWARD_SWEEP:
            dt = getattr(torch, dname)
            if dt == torch.bfloat16 and Mx < 8:
                continue
            Gx = torch.randn(Mx, N, generator=gen, device=dev).to(dt)
            reps = backward_reps(dt, Mx)
            pt = {"linear": name + "^T", "dtype": dname, "M": Mx, **{key: cuda_time(fn, **reps)["median"] for key, fn in (
                ("k11_ms", lambda: gemm_4bit_nt_fused(Gx, Bq, am, code, bs, (N, K))),
                ("k11_with_decode_ms", lambda: gemm_4bit_nt_fused(Gx, Bq, qt.state.dequant_absmax().contiguous(),
                                                                  code, bs, (N, K))),
                ("k10_matmul_T_ms", lambda: torch.matmul(Gx, dequantize_4bit_2d(Bq, am, code, bs, (N, K), dt))),
                ("k10_dq_matmul_T_ms", lambda: torch.matmul(Gx, dequantize_4bit_2d_dq(Bq, *nest, code, bs, (N, K),
                                                                                       dt))))}}
            sweep.append(pt)
            for inst, k, r in (("plain", "k11_ms", "k10_matmul_T_ms"),
                               ("nested", "k11_with_decode_ms", "k10_dq_matmul_T_ms")):
                key = f"{name}^T_{dname}_{inst}"
                if pt[k] > pt[r] and key not in crossover_bw:
                    crossover_bw[key] = Mx  # the first M at which kernel 11 trails
            del Gx
    emit("threshold_sweep_kadjacent", KADJACENT_LARGE_M_THRESHOLD=G.KADJACENT_LARGE_M_THRESHOLD,
         KADJACENT_F32_LARGE_M_THRESHOLD=G.KADJACENT_F32_LARGE_M_THRESHOLD,
         BACKWARD_LARGE_M_THRESHOLD=G.BACKWARD_LARGE_M_THRESHOLD,
         BACKWARD_F16_LARGE_M_THRESHOLD=G.BACKWARD_F16_LARGE_M_THRESHOLD,
         KADJACENT_BACKWARD_F32_LARGE_M_THRESHOLD=G.KADJACENT_BACKWARD_F32_LARGE_M_THRESHOLD,
         first_M_kernel9_trails=crossover, first_M_kernel11_trails=crossover_bw, points=sweep)
    del kq
    torch.cuda.empty_cache()

    # -- 3m. kernel 15: the fused 8-bit AdEMAMix update ---------------------
    codes_a = StateCodes(q1_map, q2_map)

    def ada_inputs(n, zero_block=False, dtype=torch.float32):
        nb = -(-n // 256)
        g = torch.randn(n, generator=gen, device=dev) * 0.01
        g[min(7, n - 1)], g[min(600, n - 1)] = float("nan"), float("inf")
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

    def ada_make(name, n, zero_block, dtype):
        return ada_inputs(n, zero_block, dtype)

    sc15 = ada_scalars(5, 1e-2, True)
    group_cases = [group_check("ademamix", sc15, lora_shapes, torch.float32, False, ada_make, codes_a)]
    torch.cuda.empty_cache()
    for step in (1, 5):
        for wd, scheduled in ((0.0, False), (1e-2, True)):
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                group_cases.append(group_check("ademamix", ada_scalars(step, wd, scheduled), RAGGED, dt, step == 1,
                                               ada_make, codes_a))
    grouped = group_time("ademamix", sc15, lora_shapes, ada_make, codes_a, 3, 40)
    torch.cuda.empty_cache()
    for leaf_t, n in ((lora_leaf, 14336 * 64), (big_leaf, 64 << 20)):
        leaf_t["device_ms"] = leaf_device_ms("ademamix", sc15, n, ada_make, codes_a)
        leaf_t["canary_bound_ms"] = leaf_t["bytes"] / canary_bs * 1e3
    torch.cuda.empty_cache()
    entry("optimizer_update_8bit_ademamix", grouped["device_ms"], grouped["plain_ms"], None, grouped["bytes"],
          40 * grouped["n"], PEAK_F32_FLOPS, 0.0,
          shape=f"the 448 adapter tensors of 4f in one launch, {grouped['n']} elements",
          rule="ademamix, step 5, scheduled, decay", grouped_step=grouped, cases=checks, grouped_cases=group_cases,
          leaf_14336x64=lora_leaf, leaf_64M=big_leaf, bf16_params=lora_leaf_bf16,
          sass_has_stl=sass_stl("optimizer_update_8bit_ademamix"),
          note="ms: one grouped step's device time, the host held out (grouped_step: ms_with_host holds it "
               "in, call_host_ms is its host time). library_ms is null: no PyTorch call computes AdEMAMix; "
               "bit-identical in every case checked")

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
        "k14 group of two types": lambda: optimizer_update_8bit_multi_(sc14, [
            opt_inputs("adam", 512), opt_inputs("adam", 512, dtype=torch.bfloat16)], codes2),
        "k14 group on two devices": lambda: optimizer_update_8bit_multi_(sc14, [
            opt_inputs("adam", 512), tuple(None if t is None else t.cpu() for t in opt_inputs("adam", 512))], codes2),
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

    # -- 3n. LLM.int8(): the int8 ops against the CPU; kernels 12 and 13's _any instances --
    # No TPU kernel stands behind the int8 path: the JAX package computes it
    # in XLA, outside any Pallas kernel.  The product is torch._int_mm
    # (cuBLASLt), the epilogues stock torch ops; each is held against the CPU.
    # Inputs come from a generator of their own.
    from torch.profiler import ProfilerActivity, profile

    from bitsandbytes_tpu_torch import autograd as A8
    from bitsandbytes_tpu_torch.functional import int8 as I8
    from bitsandbytes_tpu_torch.nn.modules import Int8TensorState
    from bitsandbytes_tpu_torch.ops.blockwise8 import QUANTIZE_BLOCKSIZES, code_tuple

    g3n = torch.Generator(device=dev).manual_seed(31)
    # the fewest rows the card's torch._int_mm takes unpadded, and whether it
    # takes K or N off a multiple of 8 (probes: the port pads below and off them)
    probe = {}
    for what, (m_, k_, n_) in {**{f"M{m}": (m, 64, 64) for m in range(1, 34)}, "K12": (32, 12, 64),
                               "N12": (32, 64, 12)}.items():
        try:
            torch._int_mm(torch.zeros(m_, k_, dtype=torch.int8, device=dev),
                          torch.zeros(n_, k_, dtype=torch.int8, device=dev).t())
            torch.cuda.synchronize()
            probe[what] = True
        except RuntimeError:
            probe[what] = False
    min_m = next((int(k[1:]) for k, ok in probe.items() if k.startswith("M") and ok), None)
    assert min_m is not None and min_m <= I8.INT_MM_MIN_M, f"torch._int_mm took no M up to 33 ({probe})"
    print(f"int_mm_smallest_unpadded_M {min_m}", flush=True)

    # row-wise quantize at thresholds 0 and 6: bf16 activations with an
    # outlier column, an all-zero row and a lone outlier
    acts = torch.randn(2048, 4096, generator=g3n, device=dev).to(torch.bfloat16)
    acts[:, 100] *= 30
    acts[7] = 0
    acts[5, 2000] = -60
    quant_cases = {}
    for th in (0.0, 6.0):
        gq, gs, gm = I8.int8_vectorwise_quant(acts, th)
        cq, cs, cm = I8.int8_vectorwise_quant(acts.cpu(), th)
        same = torch.equal(gq.cpu(), cq) and bits_equal(gs.cpu(), cs) and (
            gm is None and cm is None or torch.equal(gm.cpu(), cm))
        assert same, f"int8_vectorwise_quant at threshold {th} differs from the CPU"
        quant_cases[str(th)] = {"outlier_cols": None if gm is None else int(gm.sum()), "bit_identical": True}
    gd = I8.int8_double_quant(acts, 6.0)
    cd = I8.int8_double_quant(acts.cpu(), 6.0)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(gd, cd)), "int8_double_quant differs from the CPU"

    # the int32 product bit for bit at the Llama-3-8B linear shapes (wq and wo,
    # wk and wv, gate and up share theirs), padded as the port pads, and the
    # epilogue within float32 rounding
    I8_SHAPES = {"wq, wo": (4096, 4096), "wk, wv": (1024, 4096), "gate, up": (14336, 4096), "down": (4096, 14336)}
    prod_cases, epi_err = [], 0.0
    for names, (N_, K_) in I8_SHAPES.items():
        CBg = torch.randint(-127, 128, (N_, K_), generator=g3n, device=dev, dtype=torch.int8)
        CBc = CBg.cpu()
        SCB = torch.rand(N_, generator=g3n, device=dev) + 0.5
        for M_ in (1, 8, 16, 17, 33, 2048):
            Ag = torch.randint(-127, 128, (M_, K_), generator=g3n, device=dev, dtype=torch.int8)
            outg = I8.int8_linear_matmul(Ag, CBg)
            outc = I8.int8_linear_matmul(Ag.cpu(), CBc)
            assert torch.equal(outg.cpu(), outc), f"int8 product differs from the CPU at {names} M {M_}"
            prod_cases.append({"linear": names, "M": M_, "padded_rows": max(I8.INT_MM_MIN_M - M_, 0)})
            if M_ == 2048:
                rs = torch.rand(M_, generator=g3n, device=dev) * 4
                eg = I8.int8_mm_dequant(outg, rs, SCB, dtype=torch.float32)
                ec = I8.int8_mm_dequant(outc, rs.cpu(), SCB.cpu(), dtype=torch.float32)
                assert torch.allclose(eg.cpu(), ec, rtol=1e-6, atol=0), f"int8 epilogue differs at {names}"
                epi_err = max(epi_err, ((eg.cpu() - ec).abs() / ec.abs().clamp(min=1e-30)).max().item())

    # one int8 linear (quantize, torch._int_mm, dequantize) at decode and
    # prefill M, beside torch.matmul on the bf16 weight and torch._int_mm alone
    def device_launches(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in device_events(prof_))

    linear_times = {}
    for names, (N_, K_) in I8_SHAPES.items():
        W = (torch.randn(N_, K_, generator=g3n, device=dev) * 0.02).to(torch.bfloat16)
        st = Int8TensorState.quantize(W)
        for M_ in (8, 2048):
            x = torch.randn(M_, K_, generator=g3n, device=dev).to(torch.bfloat16)
            lt = A8.MatmulLtState(CB=st.CB, SCB=st.SCB)
            Aq = I8.int8_vectorwise_quant(x)[0]
            Aq_p = torch.nn.functional.pad(Aq, (0, 0, 0, max(I8.INT_MM_MIN_M - M_, 0)))
            with torch.no_grad():
                t_lin = cuda_time(lambda: A8.matmul(x, None, lt), flush_l2=True, hold=True)
                t_mm = cuda_time(lambda: torch.matmul(x, W.t()), flush_l2=True, hold=True)
                t_int = cuda_time(lambda: torch._int_mm(Aq_p, st.CB.t()), flush_l2=True, hold=True)
                t_plain_host = cuda_time(lambda: A8.matmul(x, None, lt), flush_l2=True)
                launches = device_launches(lambda: A8.matmul(x, None, lt))
                y = A8.matmul(x, None, lt)
            rel = ((y.float() - x.float() @ W.float().t()).norm() / (x.float() @ W.float().t()).norm()).item()
            assert rel < 0.02, f"int8 linear {names} M {M_}: relative error {rel}"
            nbytes = N_ * K_ + 4 * N_ + 2 * M_ * K_ + 2 * M_ * N_
            b_ms, b_by = bound_ms(nbytes, 2 * M_ * N_ * K_, 1979e12)
            linear_times[f"{names} M{M_}"] = {
                "device_ms": t_lin["median"], "ms_with_host": t_plain_host["median"], "launches": launches,
                "int_mm_device_ms": t_int["median"], "bf16_matmul_device_ms": t_mm["median"],
                "bound_ms": b_ms, "bound_by": b_by, "canary_bound_ms": nbytes / canary_bs * 1e3,
                "bytes": nbytes, "rel_err_vs_bf16_matmul": rel, "host_ms": t_lin["host_ms"], "spin_ms": t_lin["spin_ms"]}
        del W, st
    emit("int8_ops", smallest_unpadded_M=min_m, int_mm_probe=probe, pad_rows_to=I8.INT_MM_MIN_M,
         vectorwise_quant=quant_cases, double_quant_bit_identical=True, products_bit_identical=prod_cases,
         epilogue_max_rel_err=epi_err, linear=linear_times,
         note="device_ms: one int8 linear (row quantize, torch._int_mm, dequantize), the host held out; "
              "int_mm_device_ms: torch._int_mm alone on the padded operands (the library call); "
              "bf16_matmul_device_ms: torch.matmul on the bf16 weight (the yardstick); bound: int8 ops at "
              "1979 TOP/s or the bytes at 3.35 TB/s; L2 flushed before each call")
    del acts, CBg, CBc, Ag, outg, outc

    # kernels 12 and 13 at blocksizes outside their tiles (the _with_code
    # entry points take any blocksize): the _any instances, at ragged n, bit
    # for bit against the plain versions on the CPU, in both rounding modes
    # and on three codebooks (the buckets, the binary search, the linear count)
    ucode = create_dynamic_map(signed=False)
    fp4 = code_tuple(get_4bit_code("fp4", 64))
    any_cases = []
    for bs_any in (12, 48, 100, 8192):
        for n_any in (1000, 1_000_003):
            for cname, cb in (("dynamic", dyn), ("unsigned dynamic", ucode), ("fp4", fp4)):
                if cname != "dynamic" and (bs_any != 100 or n_any != 1000):
                    continue
                x = torch.randn(n_any, generator=g3n, device=dev)
                if cname == "unsigned dynamic":
                    x = x.abs()
                reset_launch_counts()
                qg, ag = FB.quantize_blockwise_with_code(x, cb, bs_any)
                bg = FB.dequantize_blockwise_with_code(qg, ag, cb, bs_any, torch.bfloat16)
                counts = launch_counts()
                assert counts["quantize_blockwise8_any"] == (bs_any not in QUANTIZE_BLOCKSIZES), (bs_any, counts)
                assert counts["dequantize_blockwise8_any"] == (bs_any % 8 != 0), (bs_any, counts)
                qc, ac = FB.quantize_blockwise_with_code(x.cpu(), cb, bs_any)
                bc = FB.dequantize_blockwise_with_code(qc, ac, cb, bs_any, torch.bfloat16)
                same = torch.equal(qg.cpu(), qc) and bits_equal(ag.cpu(), ac) and bits_equal(bg.cpu(), bc)
                assert same, f"_any instances differ from the plain versions at blocksize {bs_any}, n {n_any}, {cname}"
                any_cases.append({"blocksize": bs_any, "n": n_any, "code": cname, "blocks": ag.numel()})
    u_any = torch.rand(100 * 999, generator=g3n, device=dev)
    x = torch.randn(100 * 999, generator=g3n, device=dev)
    qg, ag = quantize_blockwise8(x, dyn, 100, u_any)
    qc, ac = quantize_blockwise8_plain(x.cpu(), code_tuple(dyn), 100, u_any.cpu())
    assert torch.equal(qg.cpu(), qc) and bits_equal(ag.cpu(), ac), "stochastic _any instance differs"
    # times at an lm_head-sized tensor: the _any instances at blocksize 100 beside the tiles at 128
    xl_any = torch.randn(32000 * 4096, generator=g3n, device=dev)
    code_t = code_tuple(dyn)
    t_q_any = cuda_time(lambda: quantize_blockwise8(xl_any, dyn, 100), flush_l2=True,
                        hold=True)
    t_q_tile = cuda_time(lambda: quantize_blockwise8(xl_any, dyn, 128), flush_l2=True, hold=True)
    q_any, am_any = quantize_blockwise8(xl_any, dyn, 100)
    t_dq_any = cuda_time(lambda: dequantize_blockwise8(q_any, am_any, dyn, 100, torch.bfloat16), flush_l2=True,
                         hold=True)
    q128, am128 = quantize_blockwise8(xl_any, dyn, 128)
    t_dq_tile = cuda_time(lambda: dequantize_blockwise8(q128, am128, dyn, 128, torch.bfloat16), flush_l2=True,
                          hold=True)
    t_q_plain = cuda_time(lambda: quantize_blockwise8_plain(xl_any, code_t, 100), n=3, warmup=1)
    t_dq_plain = cuda_time(lambda: dequantize_blockwise8_plain(q_any, am_any, code_t, 100, torch.bfloat16), n=3,
                           warmup=1)
    qp, ap = quantize_blockwise8_plain(xl_any, code_t, 100)
    assert torch.equal(qp, q_any) and bits_equal(ap, am_any), "_any quantize differs from plain at the lm_head size"
    dp = dequantize_blockwise8_plain(q_any, am_any, code_t, 100, torch.bfloat16)
    assert bits_equal(dp, dequantize_blockwise8(q_any, am_any, dyn, 100, torch.bfloat16)), "_any dequantize differs"
    n_l = xl_any.numel()
    qb = n_l * 4 + n_l + n_l // 100 * 4
    dqb = n_l + n_l // 100 * 4 + n_l * 2
    emit("blockwise8_any_blocksize", cases=any_cases, stochastic_bit_identical=True,
         lm_head_bs100={"quantize_any_device_ms": t_q_any["median"], "quantize_tile_bs128_device_ms": t_q_tile["median"],
                        "quantize_plain_ms": t_q_plain["median"], "quantize_bytes": qb,
                        "quantize_bound_ms": bound_ms(qb, 0, PEAK_F32_FLOPS)[0],
                        "quantize_canary_bound_ms": qb / canary_bs * 1e3,
                        "dequantize_any_device_ms": t_dq_any["median"],
                        "dequantize_8code_bs128_device_ms": t_dq_tile["median"],
                        "dequantize_plain_ms": t_dq_plain["median"], "dequantize_bytes": dqb,
                        "dequantize_bound_ms": bound_ms(dqb, 0, PEAK_F32_FLOPS)[0],
                        "dequantize_canary_bound_ms": dqb / canary_bs * 1e3},
         note="blocksizes off the tiles: quantize outside 32..4096 powers of two, dequantize off multiples of 8")
    del xl_any, q_any, am_any, q128, am128, qp, ap, dp
    torch.cuda.empty_cache()

    # -- 3o. the host quantizer (C++/OpenMP) against kernel 1 --------------
    host_quantizer(dev)

    # -- 3p. kernels 17-19: the causal flash attention of the training path --
    flash_train_kernels(dev, entry)

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

    decode_profile = {}

    kept_bf16 = {}  # 4a's profiled load keeps its bf16 tree here for 4g
    served_tokens = {}  # each serving path's greedy tokens, [batch, steps + 1]

    def serve(tag, compress, expected, keep=False, quantize=None, keep_bf16=False):
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
        served_tokens[tag] = toks
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
        decode_profile[tag] = {"device_launches_per_step": sum(e.count for e in events) / 4,
                               "device_ms_per_step": dev_us / 4e3, "wall_ms_per_step": prof_wall_ms / 4}
        top = sorted(((e.key, self_dev_us(e) / 4e3, e.count // 4) for e in events), key=lambda r: -r[1])[:8]

        # one more prefill profiled: its device time, launches and the share of
        # the dequantize (kernel 3, 6 or 10 _dq: the large-M route's)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            L.prefill(params, ids, cfg, cache)
            torch.cuda.synchronize()
            pf_wall_ms = (time.perf_counter() - t0) * 1e3
        pf_events = device_events(prof)
        pf_us = sum(self_dev_us(e) for e in pf_events)
        pf_classes = by_class(pf_events, [("dequantize", "dequantize (kernel 3, 6 or 10)"),
                                          ("flash", "attention (kernels 4, 16, combine)")])
        pf_dq = pf_classes.get("dequantize (kernel 3, 6 or 10)", {"ms": 0.0, "launches": 0})
        profiled_prefill = {"wall_ms": pf_wall_ms, "device_ms": pf_us / 1e3,
                            "device_launches": sum(e.count for e in pf_events), "dequantize_ms": pf_dq["ms"],
                            "dequantize_launches": pf_dq["launches"], "dequantize_share": pf_dq["ms"] * 1e3 / pf_us,
                            "device_busy_share": pf_us / 1e3 / pf_wall_ms, "by_class": pf_classes}
        serve_peak = torch.cuda.max_memory_allocated()

        load_profile = None
        if quantize is None:
            # the load once more from the same seed, profiled by kernel class;
            # then layer 0 through the loader's former route (each weight cast
            # to f32 first), whose bytes and states the bf16 route must give
            fresh = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
            layer0 = dict(fresh["layers"][0])
            if keep_bf16:  # the same bf16 weights, kept for the int8 load of 4g
                kept_bf16.update(fresh, layers=list(fresh["layers"]))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(cfg.num_layers):
                    fresh["layers"][i] = L.quantize_params_4bit(
                        {"layers": [fresh["layers"][i]]}, fuse=True, compress_statistics=compress)["layers"][0]
                torch.cuda.synchronize()
                ld_wall_ms = (time.perf_counter() - t0) * 1e3
            ld_events = device_events(prof)
            ld_us = sum(self_dev_us(e) for e in ld_events)
            old = L.quantize_params_4bit({"layers": [{k: v.to(torch.float32) for k, v in layer0.items()}]},
                                         fuse=True, compress_statistics=compress)["layers"][0]
            for name in ("wqkv", "wo", "gate_up", "down"):
                a = params["layers"][0][name]
                for b, route in ((fresh["layers"][0][name], "the profiled load"), (old[name], "the f32-cast route")):
                    same = bits_equal(a.data, b.data) and bits_equal(a.state.absmax, b.state.absmax)
                    if compress:
                        same = same and bits_equal(a.state.offset, b.state.offset) and bits_equal(
                            a.state.state2.absmax, b.state.state2.absmax)
                    assert same, f"{tag}: layer 0 {name} differs from {route}"
            load_profile = {"wall_ms": ld_wall_ms, "device_ms": ld_us / 1e3,
                            "device_launches": sum(e.count for e in ld_events),
                            "by_class": by_class(ld_events, [("quantize_4bit_codes", "kernel 1 (quantize_4bit_codes)"),
                                                             ("quantize_blockwise8", "kernel 13 (quantize_blockwise8)"),
                                                             ("CatArrayBatchedCopy", "concatenations (torch.cat)")]),
                            "top_kernels_ms": sorted(((e.key[:100], self_dev_us(e) / 1e3, e.count) for e in ld_events),
                                                     key=lambda r: -r[1])[:6],
                            "layer0_equals_f32_cast_route": True}
            del fresh, layer0, old
            torch.cuda.empty_cache()

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
            max_memory_allocated=max(init_peak, serve_peak),
            resident_after_load=resident, held_before_load=held, serving_peak_memory=serve_peak,
            launches=counts,
            profiled_decode={"steps": 4, "wall_ms_per_step": prof_wall_ms / 4,
                             "device_ms_per_step": dev_us / 4e3,
                             "device_launches_per_step": decode_profile[tag]["device_launches_per_step"],
                             "attention_ms_per_step": attn_us / 4e3, "attention_share": attn_us / max(dev_us, 1),
                             "device_busy_share": dev_us / 1e3 / prof_wall_ms,
                             "top_kernels_ms_per_step": top},
            profiled_prefill=profiled_prefill, profiled_load=load_profile,
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
    }, keep=True, keep_bf16=True)
    for name in ("quantize_4bit_codes", "gemm_4bit_paired", "dequantize_paired_fast", "flash_attention_cached",
                 "flash_attention_combine"):
        report[name]["launches"] = counts[name]
    # 4g. LLM.int8() serving at full width: 4a's bf16 weights (kept from its
    # profiled load, the same seed) through quantize_params_int8 (the seven
    # unfused linears of each layer; the lm_head stays bf16), then 4a's
    # serving run.  No kernel of the table runs in the linears; kernel 4 and
    # its combine run the attention.
    torch.cuda.synchronize()
    i8 = dict(kept_bf16)
    kept_bf16.clear()
    reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(Lyr):  # frees each layer's bf16 weights as it goes
        i8["layers"][i] = L.quantize_params_int8({"layers": [i8["layers"][i]]})["layers"][0]
    torch.cuda.synchronize()
    i8_load_s = time.perf_counter() - t0
    assert not any(launch_counts().values()), "the int8 load launches no kernel of the table"
    torch.cuda.empty_cache()
    i8_resident = sum(t.numel() * t.element_size() for t in E._tensors(i8))
    torch.cuda.reset_peak_memory_stats()
    cache = L.init_kv_cache(cfg, batch, max_len, device=dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = L.prefill(i8, ids, cfg, cache)
    tok = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    i8_prefill_ms = (time.perf_counter() - t0) * 1e3
    assert logits.shape == (batch, prompt, cfg.vocab_size) and torch.isfinite(logits).all()
    i8_step_ms, i8_tokens = [], [tok]
    for s in range(steps):
        t0 = time.perf_counter()
        logits, cache = L.decode_step(i8, tok, cfg, cache, prompt + s)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        i8_step_ms.append((time.perf_counter() - t0) * 1e3)
        i8_tokens.append(tok)
    counts = launch_counts()
    assert logits.shape == (batch, cfg.vocab_size) and torch.isfinite(logits).all()
    want = {k: 0 for k in counts}
    want.update({"flash_attention_cached": Lyr * (steps + 1), "flash_attention_combine": serve_combines})
    assert counts == want, f"int8 serve: launch counts {counts} != {want}"
    int8_classes = [("flash", "attention (kernel 4, combine)"), ("s8", "int8 GEMM (torch._int_mm)"),
                    ("i8", "int8 GEMM (torch._int_mm)"), ("imma", "int8 GEMM (torch._int_mm)")]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(4):
            logits, cache = L.decode_step(i8, tok, cfg, cache, prompt + steps + s)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        i8_prof_wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    i8_dev_us = sum(self_dev_us(e) for e in events)
    i8_decode_classes = {k: {"ms": v["ms"] / 4, "launches": v["launches"] / 4}
                         for k, v in by_class(events, int8_classes).items()}
    i8_top = sorted(((e.key[:100], self_dev_us(e) / 4e3, e.count // 4) for e in events), key=lambda r: -r[1])[:8]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        L.prefill(i8, ids, cfg, cache)
        torch.cuda.synchronize()
        i8_pf_wall = (time.perf_counter() - t0) * 1e3
    pf_events = device_events(prof)
    i8_pf = {"wall_ms": i8_pf_wall, "device_ms": sum(self_dev_us(e) for e in pf_events) / 1e3,
             "device_launches": sum(e.count for e in pf_events), "by_class": by_class(pf_events, int8_classes)}
    i8_serve_peak = torch.cuda.max_memory_allocated()
    lin_bytes = Lyr * sum(N_ * K_ + 4 * N_ for N_, K_ in (
        (cfg.num_heads * hd, cfg.hidden_size), (KVH * hd, cfg.hidden_size), (KVH * hd, cfg.hidden_size),
        (cfg.hidden_size, cfg.num_heads * hd), (cfg.intermediate_size, cfg.hidden_size),
        (cfg.intermediate_size, cfg.hidden_size), (cfg.hidden_size, cfg.intermediate_size)))
    head_bytes = cfg.vocab_size * cfg.hidden_size * 2
    kv_bytes = Lyr * 2 * batch * KVH * hd * 2 * (prompt + steps // 2)
    i8_step_bytes = lin_bytes + head_bytes + kv_bytes
    med = statistics.median(i8_step_ms)
    emit("serve_int8", config="llama3_8b", weights="LLM.int8() (quantize_params_int8), lm_head bf16", layers=Lyr,
         batch=batch, prompt=prompt, steps=steps, load_s=i8_load_s, resident_model_bytes=i8_resident,
         prefill_ms=i8_prefill_ms, decode_ms={"median": med, "min": min(i8_step_ms), "max": max(i8_step_ms),
                                              "n": steps},
         tok_s=batch / (med * 1e-3), step_bytes=i8_step_bytes, step_bytes_int8_linears=lin_bytes,
         step_bytes_lm_head=head_bytes, step_bytes_kv=kv_bytes,
         step_bound_ms_canary=i8_step_bytes / canary_bs * 1e3, step_bound_ms_peak=i8_step_bytes / PEAK_BYTES_S * 1e3,
         serving_peak_memory=i8_serve_peak, launches=counts,
         profiled_decode={"steps": 4, "wall_ms_per_step": i8_prof_wall / 4, "device_ms_per_step": i8_dev_us / 4e3,
                          "device_launches_per_step": sum(e.count for e in events) / 4,
                          "device_busy_share": i8_dev_us / 1e3 / i8_prof_wall, "by_class_per_step": i8_decode_classes,
                          "top_kernels_ms_per_step": i8_top},
         profiled_prefill=i8_pf, first_tokens=torch.stack(i8_tokens, 1)[0, :8].tolist(),
         resident_note="bytes of the model's tensors (CB, SCB, embed, norms, bf16 lm_head)")
    del i8, cache, logits
    torch.cuda.empty_cache()

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

    # 4h. checkpoint interop at full width: (a) 4b's double-quantized model,
    # still held, through a safetensors file and back onto the card, bit for
    # bit, serving bit-identical logits on 4b's route; (b) 4a's bf16 weights
    # under HF names through import_hf_llama("nf4"), unfused: kernel 1 once a
    # linear, then kernels 3 and 2 once a linear a prefill and a decode step
    short = 4

    def short_combines(layers):
        return layers * (short * combines(batch, Gq, max_len) + combines(batch, Gq * prompt, max_len))

    checkpoint_round_trip(cfg, nested_params, ids, max_len, {
        "dequantize_paired_fast_dq": 4 * Lyr, "gemm_4bit_paired_dq": 4 * Lyr * short,
        "flash_attention_cached": Lyr * (short + 1), "flash_attention_combine": short_combines(Lyr)})
    torch.cuda.empty_cache()
    hf_import(cfg, ids, max_len, served_tokens["serve"], {
        "dequantize_paired_fast": 7 * Lyr, "gemm_4bit_paired": 7 * Lyr * short,
        "flash_attention_cached": Lyr * (short + 1), "flash_attention_combine": short_combines(Lyr)})
    # 4i. the perplexity gate on the committed trained fixture, all 64 sequences
    perplexity_gate(os.path.dirname(os.path.abspath(__file__)), dev)
    torch.cuda.empty_cache()

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
    base_live = live_bytes()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
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
    # whose input needs no gradient; one grouped update of all adapter tensors a step
    want.update({"dequantize_paired_fast_dq": tsteps * (8 * Lyr - 1), "optimizer_update_8bit": tsteps})
    assert counts == want, f"qlora train: launch counts {counts} != {want}"
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0], f"qlora losses {losses}"
    states = [opt.state[t] for t in lparams if t.dim() > 0]
    assert all(st["state1"].dtype == torch.uint8 for st in states), "every adapter tensor keeps 8-bit states"
    train_peak = torch.cuda.max_memory_allocated()
    # what 4j's paged runs must give bit for bit: the adapters and states after the five steps
    ref_4d = {"losses": list(losses), "step_ms": {"median_2_5": statistics.median(train_ms[1:]), "all": train_ms},
              "between": torch.cuda.memory_allocated() - base_alloc, "reserved": torch.cuda.memory_reserved(),
              "live": live_bytes() - base_live, "peak": train_peak - base_alloc}
    ref_4d.update(adapters=[t.detach().clone() for t in lparams],
                  states=[t.clone() for t in state_tensors(opt, lparams)])

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        L.lora_train_step(nested_params, lora, opt, tids, cfg, token_chunk=chunk).item()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    dev_us = sum(self_dev_us(e) for e in events)
    top = sorted(((e.key[:120], self_dev_us(e) / 1e3, e.count) for e in events), key=lambda r: -r[1])[:12]
    dq_us = sum(self_dev_us(e) for e in events if "dequantize_paired" in e.key)
    classes = by_class(events, [("dequantize_paired", "kernel 6 (dequantize_paired_fast_dq)"),
                                ("optimizer_update_8bit", "kernel 14 (8-bit optimizer update)")])
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
                        "by_class": classes, "top_kernels_ms": top})
    report["optimizer_update_8bit"]["launches"] = counts["optimizer_update_8bit"]
    opt.step = opt_step
    del lora, lparams, opt, states, loss, prof
    torch.cuda.empty_cache()

    # -- 4j. paged QLoRA: 4d with paged_adamw8bit, then adamw32bit paged and not --
    paged_qlora(cfg, nested_params, tids, ref_4d, rank, alpha, chunk, tsteps)

    # -- 4p. 4d's QLoRA step over a data x seq x model mesh at one NCCL rank --
    for name, n in meshed_qlora(cfg, nested_params, tids, ref_4d, rank, alpha, chunk).items():
        report[name]["launches_4p"] = n
    del tids, ref_4d
    torch.cuda.empty_cache()

    # -- 4q. Mistral-7B on 4b's weights: serving over a seq mesh, the windowed ring, a meshed step --
    for name, n in mistral_window(nested_params, dev).items():
        report[name]["launches_4q"] = n

    # -- 4r. QLoRA training through the causal flash kernels on 4b's weights --
    for name, n in flash_qlora(nested_params, dev).items():
        report[name]["launches"] = n
    del nested_params
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
    del eng
    torch.cuda.empty_cache()

    # -- 4n. serving over a mesh at one NCCL rank, on 4a's model; virtual shards --
    sharded_serving(cfg, nf4_params, ids, prompts, dev)
    del nf4_params
    torch.cuda.empty_cache()

    # -- 4o. ring attention and GPipe at Llama-3-8B widths at one NCCL rank --
    counts_4o = ring_and_pipeline(dev)
    for name, n in counts_4o.items():
        report[name]["launches_4o"] = n

    # -- 4f. serve, then QLoRA-train with AdEMAMix, on bf16 quant_storage ---
    # (the K-adjacent layout: kernel 10's _dq mode at prefill and kernel 9's
    # nested instance at decode, then kernels 10 _dq and 15 in training; the
    # nested absmax is decoded in the kernels, never before a call)
    assert batch < G.KADJACENT_LARGE_M_THRESHOLD <= batch * prompt and tb * tt >= G.BACKWARD_LARGE_M_THRESHOLD
    from bitsandbytes_tpu_torch.functional.quant_state import QuantState
    nested_decodes = [0]  # calls of the nested absmax decode (PyTorch ops) on the path
    resolve = QuantState.dequant_absmax

    def counted_resolve(self):
        nested_decodes[0] += int(self.nested)
        return resolve(self)

    QuantState.dequant_absmax = counted_resolve
    counts, kq_params = serve("serve_kadjacent", True, {
        "quantize_4bit_codes": 4 * Lyr,
        "quantize_blockwise8": 4 * Lyr,
        "dequantize_4bit_2d_dq": 4 * Lyr,
        "gemm_4bit_fused_dq": 4 * Lyr * steps,
        "flash_attention_cached": Lyr * (steps + 1),
        "flash_attention_combine": serve_combines,
    }, keep=True, quantize=quantize_2d)
    serve_decodes = nested_decodes[0]
    assert serve_decodes == 0, f"4f serve: the nested absmax was decoded {serve_decodes} times before a call"
    report["gemm_4bit_fused_dq"]["launches"] = counts["gemm_4bit_fused_dq"]
    st0 = kq_params["layers"][0]["gate_up"].state
    assert st0.layout == "2d" and st0.inline_nested and kq_params["layers"][0]["gate_up"].data.dtype == torch.uint16
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        resolve(st0)
        torch.cuda.synchronize()
    decode_launches = sum(e.count for e in device_events(prof))  # PyTorch's kernels, none of the port's
    # a decode step launches what 4b's (the same model on the paired layout,
    # whose kernels decode in place) launches, give or take the layout's own
    # few: far less than one nested decode (decode_launches) more
    extra_launches = (decode_profile["serve_kadjacent"]["device_launches_per_step"]
                      - decode_profile["serve_nested"]["device_launches_per_step"])
    assert extra_launches < decode_launches, \
        f"4f decode: {extra_launches} launches a step more than 4b's, a nested decode is {decode_launches}"
    emit("kadjacent_decode_launches", decode_launches_per_nested_decode=decode_launches,
         launches_per_step_4f=decode_profile["serve_kadjacent"]["device_launches_per_step"],
         launches_per_step_4b=decode_profile["serve_nested"]["device_launches_per_step"],
         device_ms_per_step_4f=decode_profile["serve_kadjacent"]["device_ms_per_step"],
         device_ms_per_step_4b=decode_profile["serve_nested"]["device_ms_per_step"], nested_decodes=serve_decodes)

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
    want.update({"dequantize_4bit_2d_dq": tsteps * (8 * Lyr - 1), "optimizer_update_8bit_ademamix": tsteps})
    assert counts == want, f"qlora ademamix train: launch counts {counts} != {want}"
    # the forward and the large-M backward read the codes in kernel 10's _dq mode
    assert nested_decodes[0] == 0, f"4f train: the nested absmax was decoded {nested_decodes[0]} times"
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

    classes = by_class(events, [("dequantize_4bit_2d", "kernel 10 (dequantize_4bit_2d, _dq mode)"),
                                ("ademamix", "kernel 15 (AdEMAMix update)")])
    top = sorted(((e.key[:120], self_dev_us(e) / 1e3, e.count) for e in events), key=lambda r: -r[1])[:12]
    med = statistics.median(train_ms[1:])
    emit("qlora_train_ademamix", config="llama3_8b", layers=Lyr, layout="2d, bf16 quant_storage",
         compress_statistics=True, lora_rank=rank, lora_alpha=alpha, targets=list(LORA_TARGETS),
         optimizer="ademamix8bit", lr=1e-3, t_alpha=1000, t_beta3=1000, batch=tb, seq=tt,
         tokens_per_step=tb * tt, token_chunk=chunk, steps=tsteps, losses=losses,
         step_ms={"median_2_5": med, "all": train_ms}, tokens_per_s=tb * tt / (med * 1e-3),
         optimizer_ms={"median_2_5": statistics.median(opt_ms[1:tsteps]), "all": opt_ms[:tsteps]},
         peak_memory=train_peak, launches=counts, launches_per_step={k: v / tsteps for k, v in counts.items() if v},
         nested_decodes=nested_decodes[0], nested_decode_launches_per_call=decode_launches,
         profiled_step={"wall_ms": prof_wall_ms, "device_ms": dev_us / 1e3,
                        "device_busy_share": dev_us / 1e3 / prof_wall_ms, "by_class": classes,
                        "top_kernels_ms": top})
    for name in ("dequantize_4bit_2d_dq", "optimizer_update_8bit_ademamix"):
        report[name]["launches"] = counts[name]
    QuantState.dequant_absmax = resolve
    opt.step = opt_step
    del lora, lparams, opt, states, kq_params, tids, loss, prof
    torch.cuda.empty_cache()

    # -- 4k. the embeddings and the override optimizer at Llama-3-8B widths --
    embeddings_8b(dev)

    # -- 4l. the GPT-2/OPT family at OPT-125M's widths: bf16, NF4 and int8 --
    opt125m(dev)

    # -- 4m. one MoE layer at Mixtral-8x7B's widths ------------------------
    moe_mixtral(dev, canary_bs)

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
                     "optimizer_update_8bit": 1})
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
    prefill_k9 = B2 * T2 < G.KADJACENT_LARGE_M_THRESHOLD  # the prefill's route: kernel 9, or kernel 10 + matmul
    want.update({"dequantize_4bit_2d_dq": 0 if prefill_k9 else 4 * 2,
                 "gemm_4bit_fused_dq": 4 * 2 * (steps5d + prefill_k9),
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
    want.update({"gemm_4bit_fused_dq": 4 * 2, "gemm_4bit_nt_fused": 4 * 2 - 1,
                 "optimizer_update_8bit_ademamix": 1})
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
            for Mx in (8, G.LARGE_M_THRESHOLD):  # the first M of the dequantize route
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
    # the same on bf16 quant_storage (the K-adjacent layout, kernels 9 and 10,
    # plain and _dq), in bf16, f16 and f32, on both sides of each dtype's threshold
    for compress in (False, True):
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            lin_g = Linear4bit(K, N, bias=False, compute_dtype=dt, device=dev)
            lin_c = Linear4bit(K, N, bias=False, compute_dtype=dt, device="cpu")
            lin_g.weight = QuantizedTensor.quantize(Wl.to(dev), blocksize=bs, compress_statistics=compress,
                                                    quant_storage=torch.bfloat16)
            lin_c.weight = QuantizedTensor.quantize(Wl, blocksize=bs, compress_statistics=compress,
                                                    quant_storage=torch.bfloat16)
            assert lin_g.weight.state.layout == "2d" and lin_g.weight.state.inline_nested == compress
            sfx = "_dq" if compress else ""
            th = G.KADJACENT_F32_LARGE_M_THRESHOLD if dt == torch.float32 else G.KADJACENT_LARGE_M_THRESHOLD
            for Mx in (th - 1, th):
                x = torch.randn(Mx, K, generator=torch.Generator().manual_seed(Mx))
                torch.cuda.synchronize()
                reset_launch_counts()
                y = lin_g(x.to(dev))
                torch.cuda.synchronize()
                counts = launch_counts()
                kern = f"gemm_4bit_fused{sfx}" if Mx < th else f"dequantize_4bit_2d{sfx}"
                assert counts[kern] == 1 and sum(counts.values()) == 1, f"2d Linear4bit {dt} M {Mx}: {counts}"
                for name in ("gemm_4bit_fused", "dequantize_4bit_2d"):  # the plain instances' path
                    if kern == name:
                        report[name]["launches"] = (report[name]["launches"] or 0) + 1
                ref = lin_c(x)
                rel = ((y.cpu().float() - ref.float()).abs().max() / ref.float().abs().max()).item()
                assert y.dtype == dt and rel <= (1e-4 if dt == torch.float32 else 1e-2), \
                    f"2d Linear4bit {dt} nested {compress} M {Mx}: rel {rel}"
                lin_cases.append({"layout": "2d", "compute_dtype": str(dt)[6:], "nested": compress, "M": Mx,
                                  "kernel": kern, "rel_err_vs_cpu": rel})
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

    # -- 5f. LLM.int8() at 2 layers, card against CPU ----------------------
    # quantize_params_int8 of 5's weights: CB and SCB bit for bit; prefill and
    # four decode steps (teacher-forced); the no-cache forward at
    # int8_threshold 6 with an outlier feature planted in the embeddings; one
    # Linear8bitLt(has_fp16_weights=True, threshold=6) step at M 2048; the
    # engine over int8 weights, 4 requests, teacher-forced.  Every int8 op is
    # bit-identical on both (3n), but the bf16 ops between them are not, and
    # the row-wise int8 quantize turns a 1-ulp change of an activation into a
    # step of its row's absmax / 127: the card's logits differ from the CPU's
    # by more than 5's atol 0.1 / rtol 0.05 (reported as gate_5_logits).  They
    # are held to top-5 containment and to within the logits' own int8
    # displacement on the CPU (int8 against the bf16 weights, the same inputs).
    from bitsandbytes_tpu_torch.nn.modules import Linear8bitLt

    i8c = L.quantize_params_int8(cpu_float)
    i8g = L.quantize_params_int8(to_dev(cpu_float))
    for lc, lg in zip(i8c["layers"], i8g["layers"]):
        for name in L._LINEAR_NAMES:
            assert torch.equal(lc[name].CB, lg[name].CB.cpu()) and bits_equal(lc[name].SCB, lg[name].SCB.cpu()), name
    reset_launch_counts()
    gcache = L.init_kv_cache(cfg2, B2, 256, device=dev)
    ccache = L.init_kv_cache(cfg2, B2, 256, device="cpu")
    bcache = L.init_kv_cache(cfg2, B2, 256, device="cpu")
    glog, gcache = L.prefill(i8g, ids2.to(dev), cfg2, gcache)
    clog, ccache = L.prefill(i8c, ids2, cfg2, ccache)
    blog, bcache = L.prefill(cpu_float, ids2, cfg2, bcache)
    pairs = [(glog[:, -1].cpu(), clog[:, -1], blog[:, -1])]
    tok = glog[:, -1].argmax(-1)
    for s in range(steps2):
        glog, gcache = L.decode_step(i8g, tok, cfg2, gcache, T2 + s)
        clog, ccache = L.decode_step(i8c, tok.cpu(), cfg2, ccache, T2 + s)
        blog, bcache = L.decode_step(cpu_float, tok.cpu(), cfg2, bcache, T2 + s)
        pairs.append((glog.cpu(), clog, blog))
        tok = glog.argmax(-1)
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want.update({"flash_attention_cached": 2 * (steps2 + 1),
                 "flash_attention_combine": 2 * (steps2 * combines(B2, Gq, 256) + combines(B2, Gq * T2, 256))})
    assert counts == want, f"2-layer int8 serve: launch counts {counts} != {want}"
    serve_counts_5f = counts
    shift = max((c - b).abs().max().item() for _, c, b in pairs)  # int8's own move of the logits
    worst, gate5 = 0.0, True
    for step, (g, c, _) in enumerate(pairs):
        worst = max(worst, (g - c).abs().max().item())
        gate5 = gate5 and torch.allclose(g, c, atol=0.1, rtol=0.05)
        assert (c.topk(5, dim=-1).indices == g.argmax(-1, keepdim=True)).any(-1).all(), f"int8 top-5 at step {step}"
    assert worst <= shift, f"int8 logits: card - CPU {worst} beyond int8's own displacement {shift}"
    del gcache, ccache, bcache

    emb = cpu_float["embed"].clone()
    emb[:, 7] = 30.0  # after the RMSNorm about 18: an outlier at threshold 6
    h0 = L._rmsnorm(emb[ids2].to(cfg2.dtype), cpu_float["layers"][0]["attn_norm"], cfg2.rms_eps)
    n_out = int(I8.int8_vectorwise_quant(h0.reshape(-1, cfg2.hidden_size), 6.0)[2].sum())
    assert n_out >= 1, "the planted feature is no outlier"
    pc, pg = dict(i8c, embed=emb), dict(i8g, embed=emb.to(dev))
    with torch.no_grad():
        fg, _ = L.forward(pg, ids2.to(dev), cfg2, int8_threshold=6.0)
        fc, _ = L.forward(pc, ids2, cfg2, int8_threshold=6.0)
        f0, _ = L.forward(pc, ids2, cfg2)
        fb, _ = L.forward(dict(cpu_float, embed=emb), ids2, cfg2)
    fg = fg.cpu()
    th_shift = (fc - fb).abs().max().item()
    assert (fg - fc).abs().max().item() <= th_shift, "forward at int8_threshold 6 differs from the CPU"
    assert (fc.topk(5, dim=-1).indices == fg.argmax(-1, keepdim=True)).any(-1).all(), "threshold forward top-5"

    # one training step of LLM.int8()'s trained float weight, M = 2048 tokens:
    # grad_B's int8 product contracts the tokens (transposed operands made
    # contiguous); gradients against the CPU under 5's gates, scaled to each
    # gradient's largest magnitude
    mods = {}
    for where in ("cpu", dev):
        mods[str(where)] = Linear8bitLt(4096, 4096, has_fp16_weights=True, threshold=6.0, device=where,
                                        generator=torch.Generator(device=where).manual_seed(14))
    mc, mg = mods["cpu"], mods[str(dev)]
    with torch.no_grad():
        mg.weight.copy_(mc.weight)
        mc.bias.normal_(generator=torch.Generator().manual_seed(15))
        mg.bias.copy_(mc.bias)
    xt = torch.randn(2048, 4096, generator=torch.Generator().manual_seed(16))
    xt[:, 11] *= 25.0
    grads, new_w = {}, {}
    for m, where in ((mc, "cpu"), (mg, dev)):
        x_ = xt.to(where, copy=True).requires_grad_()
        opt = torch.optim.SGD(m.parameters(), lr=0.5)
        opt.zero_grad()
        loss_ = (m(x_).float() ** 2).mean()
        loss_.backward()
        grads[str(where)] = (loss_.detach().cpu(), x_.grad.cpu(), m.weight.grad.float().cpu(), m.bias.grad.float().cpu())
        opt.step()
        new_w[str(where)] = m.weight.detach().float().cpu()
    gc_, gg_ = grads["cpu"], grads[str(dev)]
    assert abs(gc_[0].item() - gg_[0].item()) <= 1e-3 * abs(gc_[0].item()), "Linear8bitLt loss differs"
    train_err = {}
    for what, c, g in zip(("x", "weight", "bias"), gc_[1:], gg_[1:]):
        scale = c.abs().max().item()
        assert torch.allclose(g, c, rtol=2e-2, atol=2e-3 * scale), f"Linear8bitLt grad of {what} differs from the CPU"
        train_err[what] = (g - c).abs().max().item() / scale
    assert torch.allclose(new_w[str(dev)], new_w["cpu"], rtol=2e-2, atol=2e-3 * new_w["cpu"].abs().max().item())
    del mods, mc, mg, xt, grads

    # the engine over int8 weights: 4 requests; each token of the card's
    # greedy streams in the CPU's top-5 given the stream's own prefix
    g5f = torch.Generator().manual_seed(17)
    prompts5f = [torch.randint(0, cfg2.vocab_size, (n,), generator=g5f).tolist() for n in (20, 33, 50, 61)]
    eng = ContinuousBatchingEngine(i8g, cfg2, max_batch=4, max_len=128, steps_per_sync=4)
    results, counts, prefills, dsteps, _ = engine_run(eng, lambda e: [e.add_request(p, max_new_tokens=6)
                                                                      for p in prompts5f])
    want = engine_expected(2, prefills, dsteps, "bf16", "dense", 4, 128)
    want["gemm_4bit_paired"] = want["dequantize_paired_fast"] = 0  # int8 linears: torch._int_mm
    assert counts == want, f"2-layer int8 engine: launch counts {counts} != {want}"
    eng_diff = 0.0
    for r, p in zip(results, prompts5f):
        assert len(r.tokens) == 6
        seq = torch.tensor([p + r.tokens])
        with torch.no_grad():
            lc, _ = L.forward(i8c, seq, cfg2)
            lg, _ = L.forward(i8g, seq.to(dev), cfg2)
            lb, _ = L.forward(cpu_float, seq, cfg2)
        lg = lg.cpu()
        for j, t in enumerate(r.tokens):
            assert t in lc[0, len(p) - 1 + j].topk(5).indices.tolist(), f"int8 engine token {j} of a {len(p)}-prompt"
        assert (lg - lc).abs().max() <= (lc - lb).abs().max(), "int8 engine forward differs from the CPU"
        eng_diff = max(eng_diff, (lg - lc).abs().max().item())
    emit("cpu_check_int8", layers=2, batch=B2, prompt=T2, steps=steps2, max_abs_logit_diff=worst,
         int8_displacement_on_cpu=shift, gate_5_logits=gate5, launches=serve_counts_5f,
         threshold_forward={"outlier_cols_layer0": n_out, "max_abs_logit_diff": (fg - fc).abs().max().item(),
                            "int8_displacement_on_cpu": th_shift,
                            "gate_5_logits": torch.allclose(fg, fc, atol=0.1, rtol=0.05),
                            "threshold_moves_logits_by": (fc - f0).abs().max().item()},
         linear8bitlt_step={"tokens": 2048, "loss": gc_[0].item(), "max_err_over_scale": train_err},
         engine={"prompts": [len(p) for p in prompts5f], "streams": [r.tokens for r in results],
                 "max_abs_logit_diff": eng_diff, "launches": counts})
    del i8c, i8g, pc, pg, eng
    torch.cuda.empty_cache()

    # -- 5g. checkpoint interop at 2 layers, card against CPU --------------
    interop_cpu_check(L.LlamaConfig(
        vocab_size=cfg.vocab_size // 4, hidden_size=cfg.hidden_size // 4,
        intermediate_size=cfg.intermediate_size // 4, num_layers=2, num_heads=cfg.num_heads // 4,
        num_kv_heads=cfg.num_kv_heads // 4, head_dim=cfg.head_dim), quantize_2d, dev)

    # -- 5h. GPT-2/OPT, the embeddings and the paged optimizers, card against CPU --
    slice18_cpu_check(dev)

    # -- 5i. the MoE and the sharded forward at small size, card against CPU --
    slice19_cpu_check(dev)

    # -- 5j. ring attention, GPipe and a meshed QLoRA step at small size, card against CPU --
    slice20_cpu_check(dev)

    # -- 5k. the backward's routes by g's type, the windowed ring and model over a mesh, card against CPU --
    slice21_cpu_check(dev)

    # -- 5l. the training path through the causal flash kernels at 2 layers, card against CPU --
    counts_5l = flash_cpu_check(dev)
    for name, n in counts_5l.items():
        if name in FLASH_TRAIN:
            report[name]["launches_5l"] = n
    # and in f16 (the wgmma kernels' f16 instances) and f32 (the TF32
    # forward, dK/dV and dQ)
    for dt, suffix in ((torch.float16, "_f16"), (torch.float32, "")):
        for name, n in flash_cpu_check(dev, dt).items():
            if name in FLASH_TRAIN + FLASH_TRAIN_WIDE + FLASH_TF32:
                report[name + suffix]["launches_5l"] = n
    # and in f32 at head_dim 512, where the route keeps all three kernels on
    # the wide family (their kernels-line launches)
    for name, n in flash_cpu_check(dev, torch.float32, hd=512).items():
        if name in FLASH_TRAIN_WIDE:
            report[name]["launches"] = n
    # and in bf16 at head_dim 512: the sliced instances of the three kernels
    # (their kernels-line launches)
    for name, n in flash_cpu_check(dev, torch.bfloat16, hd=512).items():
        if name in ("flash_attention_causal_fwd_sliced", "flash_attention_causal_bwd_dkv_sliced",
                    "flash_attention_causal_bwd_dq_sliced"):
            report[name]["launches"] = n
    # and in bf16 at head_dim 640: the forward's streamed instance (its
    # kernels-line launches), dK/dV and dQ on the wide family
    counts_640 = flash_cpu_check(dev, torch.bfloat16, hd=640)
    report["flash_attention_causal_fwd_streamed"]["launches"] = counts_640.get("flash_attention_causal_fwd_streamed")
    # kernel 18's combine runs where its plan splits key tiles: 5l's T 1024, not 4r's T 2048
    combine = "flash_attention_causal_bwd_dkv_combine"
    report[combine]["launches"] = counts_5l.get(combine)
    import torch.distributed as dist

    dist.destroy_process_group()

    # -- 6. kernels line and result ---------------------------------------
    kernels = [report[n] for n in TPU_KERNELS]
    for k in kernels:
        assert k["launches"] and k["launches"] > 0, k["name"]
    print(smi, flush=True)  # again, beside the numbers: the first lines scroll out of a short log
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
