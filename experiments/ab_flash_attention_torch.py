#!/usr/bin/env python3
"""A/B of the PyTorch port's causal flash attention (kernel 17, the forward
``flash_attention_causal_fwd``; kernel 18, the dK/dV backward
``flash_attention_causal_bwd_dkv``; kernel 19, dQ) across checkouts of this
repo, on one NVIDIA GPU.

    python3 experiments/ab_flash_attention_torch.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (this one, or another commit unpacked
with ``git archive``).  The roots run one after another, each in its own
process that imports ``bitsandbytes_tpu_torch`` from that root and builds its
kernels; give them in turns (A B B A) so that drift on the card shows.  Each
run:

* at the shapes of ``chip_smoke.py``'s 3p (B 1, H 32 over 8 KV heads, hd 128
  at T 1024, 2048, 4096 and 8192; H 16 over 16, hd 256 at T 4096; q and k
  packed, v a view of a fused qkv row) times kernels 17, 18 and 19 on the
  device (``cuda_time(flush_l2=True, hold=True)``, median of 20) beside
  SDPA forward and backward (``is_causal``, ``enable_gqa``; its backward
  computes dq, dk and dv in one call) on the same tensors, checks the
  output against the plain version (o within 2e-2 abs, m 1e-4, l 1e-5
  relative) and kernel 18's dk and dv and kernel 19's dq against theirs
  (each within 1e-2 of its largest magnitude; the backward takes the plain
  forward's m, l and ``di = sum(o * do)``), and fingerprints o, m, l, dk,
  dv and dq;
* trains one QLoRA step of 4r(a) (Llama-3-8B, all 32 layers, NF4 double
  quantized and fused, rank 64 on all seven targets, ``adamw8bit``, ids
  [1, 2049], ``token_chunk`` 512; random weights from seed 0) after a warm-up
  step, under ``torch.profiler``: device ms by class, kernels 17-19 apart;
* counts ``HGMMA``, ``UTMALDG`` and ``STL`` in the SASS of each forward,
  dK/dV and dQ instance of the root's build (``cuobjdump -sass``).

Prints one JSON line per run, then one line with the runs' times side by
side and whether each root gives the same bits every time it runs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = [(1, 1024, 32, 8, 128), (1, 2048, 32, 8, 128), (1, 4096, 32, 8, 128), (1, 8192, 32, 8, 128),
          (1, 4096, 16, 16, 256)]
CLASSES = [("flash_fwd_kernel", "kernel 17"), ("flash_bwd_dkv_kernel", "kernel 18"),
           ("flash_bwd_dkv_combine", "kernel 18's combine"), ("flash_bwd_dq_kernel", "kernel 19"),
           ("dequantize_paired", "kernel 6"), ("optimizer_update_8bit", "kernel 14")]
TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def sass_counts(so: str, nvcc: str, kernels=("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")):
    """HGMMA, UTMALDG and STL instructions in each instance of ``kernels``
    (None without cuobjdump)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True, timeout=300).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = name if any(k in name for k in kernels) else None
            if fn:
                found[fn] = {"HGMMA": 0, "UTMALDG": 0, "STL": 0}
        elif fn:
            for op in found[fn]:
                found[fn][op] += f" {op}" in line
    return found


def run_one(root: str) -> dict:
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.abspath(root))
    from bitsandbytes_tpu_torch import optim as O
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.ops import _lib
    from bitsandbytes_tpu_torch.ops import flash_attention as FA
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time

    dev = torch.device("cuda")
    so = _lib.build()

    def fingerprint(t):  # exact integer arithmetic on the bytes
        x = t.reshape(-1).view(torch.uint8).to(torch.int64)
        return int((x * (torch.arange(x.numel(), device=dev) % 65521 + 1)).sum())

    def dev_ms(fn):
        return cuda_time(fn, n=20, flush_l2=True, hold=True)["median"]

    gen = torch.Generator(device=dev).manual_seed(60)
    rows, prints = [], {}
    rel = lambda a, b: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()  # noqa: E731
    for B, T, H, KVH, hd in SHAPES:
        q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, T, KVH, hd, generator=gen, device=dev).to(torch.bfloat16)
        qkv = torch.randn(B, T, (H + 2 * KVH) * hd, generator=gen, device=dev).to(torch.bfloat16)
        v = qkv[..., (H + KVH) * hd:].reshape(B, T, KVH, hd)
        do = torch.randn(B, T, H, hd, generator=gen, device=dev).to(torch.bfloat16)
        o, m, l = FA.flash_attention_causal_fwd(q, k, v)
        op, mp, lp = FA.flash_attention_causal_fwd_plain(q, k, v)
        errs = {"o_abs": (o.float() - op.float()).abs().max().item(), "m_abs": (m - mp).abs().max().item(),
                "l_rel": ((l - lp).abs().max() / lp.abs().max()).item()}
        again = FA.flash_attention_causal_fwd(q, k, v)
        same = all(torch.equal(a, b) for a, b in zip(again, (o, m, l)))
        ok = errs["o_abs"] <= 2e-2 and errs["m_abs"] <= 1e-4 and errs["l_rel"] <= 1e-5 and same
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 2 * 2 * hd * B * H * T * (T + 1) // 2
        ms = dev_ms(lambda: FA.flash_attention_causal_fwd(q, k, v))
        # kernels 18 and 19 on the plain forward's m, l and di, as chip_smoke.py's 3p
        bwd = (q, k, v, do, mp, lp, (op.float() * do.float()).sum(-1).transpose(1, 2).contiguous())
        dk, dv = FA.flash_attention_causal_bwd_dkv(*bwd)
        dkp, dvp = FA.flash_attention_causal_bwd_dkv_plain(*bwd)
        dq = FA.flash_attention_causal_bwd_dq(*bwd)
        errs.update(dk_rel=rel(dk, dkp), dv_rel=rel(dv, dvp),
                    dq_rel=rel(dq, FA.flash_attention_causal_bwd_dq_plain(*bwd)))
        again_kv = FA.flash_attention_causal_bwd_dkv(*bwd)
        same_kv = (torch.equal(again_kv[0], dk) and torch.equal(again_kv[1], dv)
                   and torch.equal(FA.flash_attention_causal_bwd_dq(*bwd), dq))
        ok = ok and max(errs["dk_rel"], errs["dv_rel"], errs["dq_rel"]) <= 1e-2 and same_kv
        dkv_ms = dev_ms(lambda: FA.flash_attention_causal_bwd_dkv(*bwd))
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
        sdpa_o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        rows.append({"shape": [B, T, H, KVH, hd], "ms": ms, "tflops": flops / (ms * 1e-3) / 1e12,
                     "sdpa_ms": dev_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                              enable_gqa=True)),
                     "dkv_ms": dkv_ms, "dkv_tflops": 2 * flops / (dkv_ms * 1e-3) / 1e12,
                     "dq_ms": dev_ms(lambda: FA.flash_attention_causal_bwd_dq(*bwd)),
                     "sdpa_bwd_ms": dev_ms(lambda: torch.autograd.grad(sdpa_o, (qg, kg, vg), dot, retain_graph=True)),
                     "errs": errs, "run_to_run_bits": same and same_kv, "ok": ok})
        prints[str(rows[-1]["shape"])] = [fingerprint(t) for t in (o, m, l, dk, dv, dq)]
        del q, k, qkv, v, do, o, m, l, op, mp, lp, again, qt, kt, vt, bwd, dk, dv, dq, dkp, dvp, again_kv
        del qg, kg, vg, sdpa_o, dot
        torch.cuda.empty_cache()

    # 4r(a): one profiled QLoRA step at T 2048 through kernels 17-19
    cfg = L.LlamaConfig.llama3_8b()
    params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    for i in range(cfg.num_layers):
        params["layers"][i] = L.quantize_params_4bit({"layers": [params["layers"][i]]}, fuse=True,
                                                     compress_statistics=True)["layers"][0]
    lora = L.add_lora(cfg, rank=64, alpha=16.0, targets=TARGETS, generator=torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    opt = O.adamw8bit(L.lora_parameters(lora), 1e-3)
    ids = torch.randint(0, cfg.vocab_size, (1, 2049), generator=torch.Generator(device=dev).manual_seed(70),
                        device=dev)
    assert L._flash_ok(cfg, 2048, cfg.head_dim, dev)
    loss0 = L.lora_train_step(params, lora, opt, ids, cfg, token_chunk=512).item()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss1 = L.lora_train_step(params, lora, opt, ids, cfg, token_chunk=512).item()
        torch.cuda.synchronize()

    def self_us(e):  # named self_cuda_time_total before torch 2.4
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    classes = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or self_us(e) <= 0 or getattr(e, "is_user_annotation", False) \
                or e.key.startswith("Optimizer."):
            continue
        label = next((lab for sub, lab in CLASSES if sub in e.key), None)
        if label is None:
            low = e.key.lower()
            label = ("GEMM (cuBLAS)" if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas", "nvjet"))
                     else "copies and casts" if ("copy" in low or "cast" in low) else "other PyTorch kernels")
        c = classes.setdefault(label, {"ms": 0.0, "launches": 0})
        c["ms"] += self_us(e) / 1e3
        c["launches"] += e.count
    step = {"losses": [loss0, loss1], "device_ms": sum(c["ms"] for c in classes.values()), "by_class": classes}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"root": root, "card": card, "fwd": rows, "step_4r_a": step,
            "sass": sass_counts(so, _lib._nvcc()), "fingerprints": prints}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], capture_output=True,
                             text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    by_root = {}
    for r in runs:
        by_root.setdefault(r["root"], []).append(r["fingerprints"])
    def by_shape(key):
        return [{"root": r["root"], **{str(x["shape"]): x[key] for x in r["fwd"]}} for r in runs]

    print(json.dumps({"fwd_ms": by_shape("ms"), "sdpa_ms": by_shape("sdpa_ms"), "dkv_ms": by_shape("dkv_ms"),
                      "dq_ms": by_shape("dq_ms"), "sdpa_bwd_ms": by_shape("sdpa_bwd_ms"),
                      "step_4r_a_ms": [{"root": r["root"], "step_device_ms": r["step_4r_a"]["device_ms"],
                                        **{lab: r["step_4r_a"]["by_class"].get(lab, {}).get("ms")
                                           for lab in ("kernel 17", "kernel 18", "kernel 18's combine",
                                                       "kernel 19")}} for r in runs],
                      "all_ok": all(x["ok"] for r in runs for x in r["fwd"]),
                      "same_bits_within_root": {k: all(p == v[0] for p in v) for k, v in by_root.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
