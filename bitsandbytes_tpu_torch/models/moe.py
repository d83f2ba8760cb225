"""Mixture-of-Experts FFN on 4-bit experts, and expert parallelism.

Counterpart of the JAX package's ``models/moe.py``: a router and a stack of
SwiGLU experts whose ``gate_up [2*ffn, hidden]`` and ``down [hidden, ffn]``
weights are 4-bit.  Routing is dense top-k: every expert computes over
every token and the gates (zero outside each token's top k) weigh and add
the outputs in f32.  Each expert's two linears run through
``autograd.matmul_4bit`` on their own layout (kernel 2 below
``functional/gemm.LARGE_M_THRESHOLD`` rows, kernel 3 and ``torch.matmul``
from it), and ``init_moe_params`` quantizes with kernel 1 on CUDA.

The tree is the JAX package's: ``router`` (f32), ``gate_up_data``,
``gate_up_absmax``, ``down_data`` and ``down_absmax``, each stacked on a
leading expert axis.  ``meta`` records each weight's quant type,
blocksize, shape and layout; the JAX package records no layout and reads
its paired experts as flat (see ROADMAP, Queue 3), which this module does
not copy.

The gates are computed in f64 and rounded once to f32 (the logits, then the
softmax), so the card and the CPU pick the same experts and the same gate
values bit for bit; they agree with the JAX package's f32 gates to within
its rounding.  :func:`moe_ffn_expert_parallel` splits the experts over a
mesh axis: each rank computes its experts for every token and an f32 sum
over the axis combines them, as the JAX package's ``psum`` does.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import autograd
from ..functional.codebooks import get_4bit_code
from ..functional.quant_state import QuantState
from ..nn.modules import QuantizedTensor
from ..ops.dispatch import resolve_device

__all__ = ["init_moe_params", "moe_ffn", "moe_ffn_expert_parallel", "moe_gates"]


def init_moe_params(hidden: int, ffn: int, n_experts: int, blocksize: int = 64, quant_type: str = "nf4", *,
                    generator: Optional[torch.Generator] = None, device=None):
    """Router and stacked 4-bit SwiGLU experts from ``generator`` (on
    ``device``, CUDA unless named; seed 0 when omitted): normal weights
    times ``fan_in ** -0.5``, the router in f32, each expert quantized with
    ``QuantizedTensor.quantize`` (layout ``"auto"``: paired where the shape
    allows).  Returns ``(params, meta)``; ``meta[name]`` is ``(quant_type,
    blocksize, shape, layout)`` of one expert's weight."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, dtype=torch.float32, generator=generator, device=device)

    router = normal(n_experts, hidden) * hidden**-0.5
    stacks = {"gate_up_data": [], "gate_up_absmax": [], "down_data": [], "down_absmax": []}
    meta = {}
    for _ in range(n_experts):
        for name, (n, k) in (("gate_up", (2 * ffn, hidden)), ("down", (hidden, ffn))):
            q = QuantizedTensor.quantize(normal(n, k) * k**-0.5, blocksize=blocksize, quant_type=quant_type)
            stacks[name + "_data"].append(q.data)
            stacks[name + "_absmax"].append(q.state.absmax)
            meta[name] = (q.state.quant_type, q.state.blocksize, tuple(q.state.shape), q.state.layout)
    params = {"router": router, **{k: torch.stack(v) for k, v in stacks.items()}}
    return params, meta


@functools.lru_cache(maxsize=None)
def _code(quant_type: str, blocksize: int, device: torch.device) -> torch.Tensor:
    """The codebook as a tensor on ``device``, copied there once: a state
    built per call must not copy it from the host each time."""
    return torch.from_numpy(get_4bit_code(quant_type, blocksize).copy()).to(device)


def _matmul(x, data, absmax, meta_entry):
    quant_type, blocksize, shape, layout = meta_entry
    st = QuantState(absmax=absmax, code=_code(quant_type, blocksize, absmax.device), blocksize=blocksize,
                    quant_type=quant_type, dtype=x.dtype, shape=tuple(shape), layout=layout)
    return autograd.matmul_4bit(x, data, st)


def _expert_ffn(x, gu_data, gu_am, dn_data, dn_am, meta):
    gu = _matmul(x, gu_data, gu_am, meta["gate_up"])
    g, u = torch.chunk(gu, 2, dim=-1)
    h = (torch.nn.functional.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    return _matmul(h, dn_data, dn_am, meta["down"])


def moe_gates(x: torch.Tensor, router: torch.Tensor, top_k: int) -> torch.Tensor:
    """``[B, E]`` f32 gates: the softmax of the router logits over each
    token's top ``top_k`` experts (ties with the k-th kept, as the JAX
    package keeps them), zero elsewhere.  Logits and softmax run in f64,
    each rounded once to f32."""
    logits = (x.to(torch.float64) @ router.to(torch.float64).t()).to(torch.float32)
    if top_k < router.shape[0]:
        thresh = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= thresh, logits, float("-inf"))
    return torch.softmax(logits.to(torch.float64), dim=-1).to(torch.float32)


def _combine(x, gates, params, meta, experts) -> torch.Tensor:
    out = torch.zeros(x.shape[0], x.shape[-1], dtype=torch.float32, device=x.device)
    for j, e in enumerate(experts):
        y = _expert_ffn(x, params["gate_up_data"][j], params["gate_up_absmax"][j], params["down_data"][j],
                        params["down_absmax"][j], meta)
        out = out + gates[:, e : e + 1] * y.to(torch.float32)
    return out


def moe_ffn(params: dict, meta: dict, x: torch.Tensor, top_k: int = 2) -> torch.Tensor:
    """Dense MoE on one device: ``x [B, hidden]`` -> ``[B, hidden]`` in
    ``x``'s type; every expert computes, the gates weigh."""
    gates = moe_gates(x, params["router"], top_k)
    return _combine(x, gates, params, meta, range(params["router"].shape[0])).to(x.dtype)


def moe_ffn_expert_parallel(params: dict, meta: dict, x: torch.Tensor, mesh, axis: str = "expert",
                            top_k: int = 2) -> torch.Tensor:
    """Expert-parallel MoE over ``axis`` of ``mesh`` (a ``parallel.Mesh``):
    this rank holds experts ``[i * E/s, (i+1) * E/s)``, the dim-0 shard of
    the stacked leaves.  ``params`` is either the whole tree (the rank takes
    its slice, a view) or the rank's shard already.  The gates are computed
    on every rank; the ranks' f32 partial sums are added over the axis."""
    E = params["router"].shape[0]
    s = mesh.axis_size(axis)
    if E % s:
        raise ValueError(f"{E} experts do not shard over {s}")
    e_local = E // s
    e0 = mesh.index(axis) * e_local
    held = params["gate_up_data"].shape[0]
    if held == E:
        local = {k: v[e0 : e0 + e_local] for k, v in params.items() if k != "router"}
    elif held == e_local:
        local = params
    else:
        raise ValueError(f"params hold {held} experts: neither all {E} nor this rank's {e_local}")
    gates = moe_gates(x, params["router"], top_k)
    part = _combine(x, gates, local, meta, range(e0, e0 + e_local))
    return mesh.all_reduce(part, axis).to(x.dtype)
