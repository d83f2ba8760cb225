#!/usr/bin/env python3
"""Design variants of kernel 19, the causal flash attention dQ backward
(``csrc/flash_attention.cu``, ``flash_bwd_dq_kernel``), built side by side
from text-edited copies of this checkout's source and timed in one process
on one NVIDIA GPU.

    python3 experiments/ab_flash_dq_variants_torch.py [VARIANT ...]

With no arguments it runs every variant, the source as it stands first and
last.  Each copy goes to ``_probe/dq_variants/<name>/`` (git-ignored) and
builds alone with ``nvcc -Xptxas -v``; its ``mbar_wait`` traps after 2^24
tries, so a variant that deadlocks fails its launch instead of hanging the
card (every variant carries the trap: compare them with each other, not with
``ab_flash_attention_torch.py``'s times).  For each variant: ptxas's
registers, spills and C75xx notes (``wgmma`` serialized) of each dQ
instance, its SASS counts (``HGMMA``, ``UTMALDG``, ``STL``), and at
``chip_smoke.py`` 3p's five timed shapes and its two batched ones dq against
the plain version (within 1e-2 of its largest magnitude, bit for bit twice)
and, at the timed shapes, the device ms (``cuda_time(flush_l2=True,
hold=True)``, median of 20).

The variants (hd 128 unless named; hd 256 keeps one consumer of 64 rows
and two stages in all of them):

* ``source``: the kernel as committed;
* ``rows64``: one consumer of 64 rows a block (160 threads) and two blocks an
  SM, against the source's two consumers of 128 rows and one block an SM;
* ``stages3``, ``stages4``: a ring of three or four 64-key stages (two in
  the source);
* ``overlap``: the next tile's S and dP products issued while this tile's
  dQ product runs (its stage released a tile later), with two stages and
  with four (``overlap4``);
* ``pingpong``: the two consumers take turns to issue their S and dP
  products (named barriers), so that one's products run while the other
  computes p and ds;
* ``cluster``: blocks in clusters of two, the query heads 2 i and 2 i + 1 of
  one KV head (G even): each block's producer loads one 64-column chunk of
  every K and V tile and multicasts it by TMA to both blocks, and each
  consumer warp releases a stage in both blocks.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "bitsandbytes_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "_probe", "dq_variants")
SHAPES = [(1, 1024, 32, 8, 128), (1, 2048, 32, 8, 128), (1, 4096, 32, 8, 128), (1, 8192, 32, 8, 128),
          (1, 4096, 16, 16, 256)]
BATCHED = [(2, 1152, 8, 2, 128), (3, 640, 2, 1, 256)]


def sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the source no longer holds {old[:60]!r} once")
    return src.replace(old, new)


def trap(sm90: str) -> str:
    return sub(sm90, """    do {
        asm volatile(
            "{\\n.reg .pred p;\\nmbarrier.try_wait""", """    uint32_t tries = 0;
    do {
        if (++tries == (1u << 24)) __trap();
        asm volatile(
            "{\\n.reg .pred p;\\nmbarrier.try_wait""")


def rows64(src: str) -> str:
    src = sub(src, """struct DqCfg {
    static constexpr int kConsumers = HD == 128 ? 2 : 1;""", """struct DqCfg {
    static constexpr int kConsumers = 1;""")
    return sub(src, "__launch_bounds__(DqCfg<HD>::kThreads, 1)",
               "__launch_bounds__(DqCfg<HD>::kThreads, HD == 128 ? 2 : 1)")


def stages(n: int):
    def edit(src: str) -> str:
        old = """    static constexpr int kKeys = 64;  // keys of a ring stage
    static constexpr int kStages = 2;"""
        return sub(src, old, old.replace("kStages = 2;", f"kStages = HD == 128 ? {n} : 2;"))
    return edit


def overlap(src: str) -> str:
    """dQ of tile t stays in flight while tile t + 1's S and dP are issued;
    the stage of tile t is released once that dQ product lands."""
    return sub(src, """    mbar_wait(full_q, 0);
    for (int t = 0; t < ntiles; ++t) {
        issue_sdp(t);
        wgmma_wait<1>();  // S has landed, dP may still run
        fence_regs(s);
        probs(t);
        wgmma_wait<0>();
        fence_regs(dp);
        dsoft();
        issue_dq(t);
        wgmma_wait<0>();
        dq_landed();
        release(t);
    }
""", """    mbar_wait(full_q, 0);
    issue_sdp(0);
    for (int t = 0; t < ntiles; ++t) {
        wgmma_wait<1>();  // the last tile's dQ and this S have landed, dP may still run
        fence_regs(s);
        dq_landed();
        if (t > 0) release(t - 1);
        probs(t);
        wgmma_wait<0>();
        fence_regs(dp);
        dsoft();
        issue_dq(t);
        if (t + 1 < ntiles) issue_sdp(t + 1);
    }
    wgmma_wait<0>();
    dq_landed();
    release(ntiles - 1);
""")


def pingpong(src: str) -> str:
    """Consumer w waits for its turn (named barrier 2 + w) before issuing a
    tile's S and dP and then hands the turn to the other; the second
    consumer's last tile (the first has one fewer) takes no turn."""
    src = sub(src, """template <int HD>
struct DqCfg {""", """__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}

template <int HD>
struct DqCfg {""")
    return sub(src, """    mbar_wait(full_q, 0);
    for (int t = 0; t < ntiles; ++t) {
        issue_sdp(t);
""", """    mbar_wait(full_q, 0);
    constexpr bool kPing = C::kConsumers == 2;
    if (kPing && wg == 1) named_barrier_arrive(2, 256);  // the first consumer goes first
    for (int t = 0; t < ntiles; ++t) {
        if (kPing && !(wg == 1 && t == ntiles - 1)) named_barrier_sync(2 + wg, 256);
        issue_sdp(t);
        if (kPing && (wg == 0 || t + 2 < ntiles)) named_barrier_arrive(3 - wg, 256);
""")


CLUSTER_HELPERS = """__device__ __forceinline__ uint32_t cluster_ctarank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\\n" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\\n" : "=r"(r));
    return r;
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\\nbarrier.cluster.wait.acquire.aligned;\\n" ::: "memory");
}

// an arrival on the barrier at the same offset in block `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, uint32_t cta) {
    asm volatile(
        "{\\n.reg .b32 ra;\\nmapa.shared::cluster.u32 ra, %0, %1;\\n"
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\\n}\\n" ::"r"(smem_addr(bar)),
        "r"(cta)
        : "memory");
}

// tma_load_4d into every block of `mask`, at dst's offset, completing on the
// barrier at bar's offset in each
__device__ __forceinline__ void tma_load_4d_mc(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                               int c2, int c3, uint16_t mask) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1, "
        "{%3, %4, %5, %6}], [%2], %7;\\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "h"(mask)
        : "memory");
}

"""


def cluster(src: str) -> str:
    """Clusters of two blocks at hd 128 when G is even (one block a cluster
    otherwise): K and V multicast, each half loaded by one block; stages
    released in both blocks; a cluster barrier after the barriers' setup and
    before any block exits (a peer's arrivals may still reach its barriers)."""
    src = sub(src, """template <int HD>
struct DqCfg {""", CLUSTER_HELPERS + """template <int HD>
struct DqCfg {""")
    src = sub(src, """    const int wg = threadIdx.x / 128;  // a consumer warpgroup, or kConsumers: the producer warp

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int st = 0; st < C::kStages; ++st) {
            mbar_init(full + st, 1);
            mbar_init(empty + st, 4 * C::kConsumers);  // each consumer warp once
        }
        mbar_fence_init();
    }
    __syncthreads();
""", """    const int wg = threadIdx.x / 128;  // a consumer warpgroup, or kConsumers: the producer warp
    const uint32_t ncta = cluster_nctarank(), crank = cluster_ctarank();

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int st = 0; st < C::kStages; ++st) {
            mbar_init(full + st, 1);
            mbar_init(empty + st, 4 * C::kConsumers * ncta);  // each consumer warp of the cluster once
        }
        mbar_fence_init();
    }
    if (ncta > 1)
        cluster_sync();
    else
        __syncthreads();
""")
    src = sub(src, """                for (int c = 0; c < C::kChunks; ++c) {
                    tma_load_4d(sK(st) + c * N * 128, &tk, full + st, c * 64, kvh, t * N, b);
                    tma_load_4d(sV(st) + c * N * 128, &tv, full + st, c * 64, kvh, t * N, b);
                }
            }
        }
        return;
    }
""", """                for (int c = 0; c < C::kChunks; ++c) {
                    if (ncta == 1) {
                        tma_load_4d(sK(st) + c * N * 128, &tk, full + st, c * 64, kvh, t * N, b);
                        tma_load_4d(sV(st) + c * N * 128, &tv, full + st, c * 64, kvh, t * N, b);
                    } else if (c % ncta == crank) {
                        const uint16_t mask = (uint16_t)((1u << ncta) - 1);
                        tma_load_4d_mc(sK(st) + c * N * 128, &tk, full + st, c * 64, kvh, t * N, b, mask);
                        tma_load_4d_mc(sV(st) + c * N * 128, &tv, full + st, c * 64, kvh, t * N, b, mask);
                    }
                }
            }
        }
        __syncwarp();
        if (ncta > 1) cluster_sync();
        return;
    }
""")
    src = sub(src, """        if (lane == 0) mbar_arrive(empty + t % C::kStages);  // this warp is done with the stage
    };
""", """        if (lane == 0)
            for (uint32_t c = 0; c < ncta; ++c) mbar_arrive_cta(empty + t % C::kStages, c);
    };
""")
    src = sub(src, """            *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) = pack_bf16x2(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
    }
}
""", """            *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) = pack_bf16x2(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
    }
    if (ncta > 1) cluster_sync();
}
""")
    return sub(src, """    flash_bwd_dq_kernel<HD><<<dim3(p.H, B, p.T / C::kRows), C::kThreads, C::kBytes, stream>>>(tq, tk, tv, tdo, p);
    return (int)cudaGetLastError();""", """    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.H, B, p.T / C::kRows);
    cfg.blockDim = dim3(C::kThreads);
    cfg.dynamicSmemBytes = C::kBytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = HD == 128 && (p.H / p.KVH) % 2 == 0 ? 2 : 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t l = cudaLaunchKernelEx(&cfg, flash_bwd_dq_kernel<HD>, tq, tk, tv, tdo, p);
    if (l != cudaSuccess) return (int)l;
    return (int)cudaGetLastError();""")


def same(src: str) -> str:
    return src


# name -> the source edits, applied in order
VARIANTS = {
    "source": [same],
    "rows64": [rows64],
    "stages3": [stages(3)],
    "stages4": [stages(4)],
    "overlap": [overlap],
    "overlap4": [overlap, stages(4)],
    "pingpong": [pingpong],
    "cluster": [cluster],
    "cluster_stages4": [cluster, stages(4)],
}


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def build(names, nvcc, flags):
    """Each variant's copy of the sources and its library, built at once:
    {name: (so, ptxas lines of the dQ kernels)}."""
    src = open(os.path.join(CSRC, "flash_attention.cu")).read()
    sm90 = trap(open(os.path.join(CSRC, "sm90.cuh")).read())
    procs, built = {}, {}
    for n in names:
        text = src
        for edit in VARIANTS[n]:
            text = edit(text)
        d = os.path.join(OUT, n)
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(CSRC, "common.cuh"), d)
        with open(os.path.join(d, "sm90.cuh"), "w") as f:
            f.write(sm90)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(text)
        cmd = [nvcc, *flags, "-shared", "-Xptxas", "-v", "-I", d, os.path.join(d, "flash_attention.cu"),
               "-o", os.path.join(d, "fa.so")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for n, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{n}: nvcc failed\n{out[-6000:]}")
        ptxas, fn = {}, None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"flash_bwd_dq_kernelILi(\d+)", line)
                fn = f"dq_hd{m.group(1)}" if m else None
            elif fn and ("spill" in line or "Used" in line):
                ptxas.setdefault(fn, []).append(line.strip().removeprefix("ptxas info    : "))
            if "(C75" in line:
                code = "C75" + line.split("(C75")[1][:2]
                m = re.search(r"(flash_\w+?_kernel)ILi(\d+)", line)
                ptxas.setdefault("notes", []).append(f"{code} {m.group(1)}<{m.group(2)}>" if m else line[-160:])
        built[n] = (os.path.join(OUT, n, "fa.so"), ptxas)
    return built


def sass_counts(so: str, nvcc: str) -> dict:
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    sass, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1]
            fn = ("hd256" if "ILi256" in name else "hd128") if "flash_bwd_dq_kernel" in name else None
            if fn:
                sass[fn] = {"HGMMA": 0, "UTMALDG": 0, "STL": 0}
        elif fn:
            for op in sass[fn]:
                sass[fn][op] += f" {op}" in line
    return sass


def main(argv) -> int:
    import torch

    sys.path.insert(0, ROOT)
    from bitsandbytes_tpu_torch.ops import _lib
    from bitsandbytes_tpu_torch.ops import flash_attention as FA
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    order = argv or ["source", *[n for n in VARIANTS if n != "source"], "source"]
    names = list(dict.fromkeys(order))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    nvcc = _lib._nvcc()
    libs = {}
    for n, (so, ptxas) in build(names, nvcc, _lib._NVCC_FLAGS).items():
        emit("build", variant=n, ptxas=ptxas, sass=sass_counts(so, nvcc))
        lib = ctypes.CDLL(so)
        fn = "bnb_flash_attention_causal_bwd_dq"
        getattr(lib, fn).argtypes = _lib._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
        libs[n] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(60)
    data = []
    for B, T, H, KVH, hd in SHAPES + BATCHED:
        q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, T, KVH, hd, generator=gen, device=dev).to(torch.bfloat16)
        qkv = torch.randn(B, T, (H + 2 * KVH) * hd, generator=gen, device=dev).to(torch.bfloat16)
        v = qkv[..., (H + KVH) * hd:].reshape(B, T, KVH, hd)
        do = torch.randn(B, T, H, hd, generator=gen, device=dev).to(torch.bfloat16)
        o, m, l = FA.flash_attention_causal_fwd_plain(q, k, v)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, m, l, di)
        data.append(([B, T, H, KVH, hd], bwd, FA.flash_attention_causal_bwd_dq_plain(*bwd)))
        del o
    rel = lambda a, b: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()  # noqa: E731
    for n in order:
        _lib._lib = libs[n]
        rows = []
        for shape, bwd, dqp in data:
            dq = FA.flash_attention_causal_bwd_dq(*bwd)
            torch.cuda.synchronize()
            err = rel(dq, dqp)
            same = torch.equal(FA.flash_attention_causal_bwd_dq(*bwd), dq)
            row = {"shape": shape, "ok": err <= 1e-2 and same, "dq_rel": err, "bits_twice": same}
            if shape[:1] == [1]:  # the timed shapes
                row["ms"] = cuda_time(lambda: FA.flash_attention_causal_bwd_dq(*bwd), n=20, flush_l2=True,
                                      hold=True)["median"]
            rows.append(row)
        emit("variant", variant=n, rows=rows)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
