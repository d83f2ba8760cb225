"""Continuous-batching generation engine.

Counterpart of the JAX package's ``bitsandbytes_tpu/serving/engine.py``.  It
serves a quantized Llama-family model (``models/llama.py``: 4-bit or
LLM.int8() weights) with:

* **slot-based continuous batching**: a fixed-size decode batch whose slots
  are occupied and retired per request; new requests join the running batch
  without stalling the others (the decode step takes a per-slot position
  vector).
* **chunked decode**: ``steps_per_sync`` decode steps per host round trip,
  the tokens chained on the device, and up to ``pipeline_depth`` chunks in
  flight before the host reads the oldest.
* **an int8 KV cache** (``kv_dtype="int8"``): half the KV bytes of bf16,
  read natively by the flash kernels (scales after the dot).
* **a paged KV cache** (``kv_layout="paged"``): a shared block pool and
  per-slot block tables; KV memory scales with ``num_kv_blocks``, admission
  waits for blocks, and a pool that runs dry mid-decode preempts the
  youngest request, which resumes by recomputing its prefix.

What the JAX package does with donated jitted functions, this engine does
with in-place writes into the one cache object; its random-key folding
becomes a ``torch.Generator`` on the engine's device, re-seeded from
``seed`` per chunk and per request, so sampled streams are reproducible but
draw other bits than the JAX package's.  Prompts are padded to powers of 4
(at least 16 tokens; for a paged cache at least one block), as there.  Host
syncs: one fetch per processed chunk, one in the rare preemption of a slot
whose first token is still on the device, and the synchronous uploads of
tables, positions and sampling settings when the slot set changes.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import llama as L
from ..nn.modules import Int8TensorState, QuantizedTensor
from ..ops.dispatch import resolve_device
from ..ops.flash_cached import tp_axes
from ..parallel.mesh import Mesh
from ..parallel.sharding import Sharded, llama_param_specs, shard_kv_cache

__all__ = ["ContinuousBatchingEngine", "GenerationResult"]


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt: List[int]
    tokens: List[int]
    finished_reason: str  # "eos" | "length"
    # host-observed latencies: submission -> first token visible to the
    # host, and submission -> completion.  With pipelined chunks the host
    # sees tokens up to pipeline_depth-1 chunks after the device made them.
    ttft_s: float = 0.0
    total_s: float = 0.0


@dataclasses.dataclass
class _Slot:
    request_id: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_t: float = 0.0
    first_t: float = 0.0
    admit_seq: int = 0  # admission order; preemption evicts the youngest

    @property
    def prefill_ids(self) -> List[int]:
        """What the prefill consumes: the prompt, plus the tokens generated
        before a preemption re-queued the request, so it resumes where it
        stopped."""
        return self.prompt + self.tokens


_DEFAULT_POOL = 64  # default sampling candidate pool
_DECODE, _PREFILL = 0, 1  # seed tags keeping the decode and prefill draws apart


def _seed(*words: int) -> int:
    """A generator seed mixed from non-negative integers (where the JAX
    package folds them into a key)."""
    state = np.random.SeedSequence([int(w) & ((1 << 64) - 1) for w in words]).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def _nucleus(logits, temps, top_ps, pool: int):
    """The top-``pool`` candidates of each row (``idxs``), their
    temperature-scaled logits, and which of them lie in the nucleus.  The
    candidates' probabilities are normalized over the full vocabulary, so
    the cutoff uses true probabilities; the top candidate is always kept
    (``top_p == 0`` would keep none)."""
    pool = min(pool, logits.shape[-1])
    l32 = logits.to(torch.float32)
    inv_t = 1.0 / temps.clamp(min=1e-6)[:, None]
    vals, idxs = torch.topk(l32, pool, dim=-1)
    scaled = vals * inv_t
    lse = torch.logsumexp(l32 * inv_t, dim=-1, keepdim=True)
    probs = torch.exp(scaled - lse)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_ps[:, None]
    keep[:, 0] = True
    return idxs, scaled, keep


def _sample_tokens(logits, temps, top_ps, generator: torch.Generator, pool: int = _DEFAULT_POOL):
    """Per-slot temperature + nucleus (top-p) sampling; slots with
    temperature <= 0 take the argmax.

    ``logits [B, V]``; ``temps``/``top_ps [B]``.  Top-p runs inside the
    top-``pool`` candidate set with full-vocabulary probabilities
    (:func:`_nucleus`): whenever the true nucleus lies inside the pool (and
    always when ``pool >= V``) the draw is exact nucleus sampling; otherwise
    the nucleus is truncated to the pool.  The draw is a Gumbel-max over the
    kept candidates, from uniforms drawn on the logits' device with
    ``generator``: no host sync."""
    greedy = logits.argmax(dim=-1)
    idxs, scaled, keep = _nucleus(logits, temps, top_ps, pool)
    logp = torch.where(keep, scaled, float("-inf"))
    u = torch.rand(logp.shape, generator=generator, device=logp.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    choice = (logp + gumbel).argmax(dim=-1, keepdim=True)
    sampled = idxs.gather(-1, choice)[:, 0]
    return torch.where(temps > 0, sampled, greedy)


@torch.no_grad()
def _decode_chunk(params, cache, tokens, positions, temps, top_ps, generator, *, cfg, S: int,
                  sampling: bool, pool: int, mesh=None) -> torch.Tensor:
    """S decode steps in a Python loop; each step's tokens feed the next on
    the device, with no host sync inside the chunk.  Slots that finish
    mid-chunk make extra tokens that the host discards.  ``sampling=False``
    (every slot greedy) takes the argmax alone.  Returns ``[S, B]`` int64."""
    out = torch.empty(S, tokens.shape[0], dtype=torch.int64, device=tokens.device)
    toks, pos = tokens, positions
    for i in range(S):
        logits, _ = L.forward(params, toks[:, None], cfg, cache=cache, start_pos=pos, mesh=mesh)
        last = logits[:, 0]
        toks = _sample_tokens(last, temps, top_ps, generator, pool) if sampling else last.argmax(dim=-1)
        out[i] = toks
        pos = pos + 1
    return out


@torch.no_grad()
def _prefill_batch(params, cache_n, ids, true_lens, temps, top_ps, generator, *, cfg, sampling: bool,
                   pool: int, mesh=None) -> torch.Tensor:
    """Several prompts padded to one length run as one forward through the
    dense cache ``cache_n``; returns each row's next token (``[n]``).
    ``ids [n, pad_len]`` on the device; ``true_lens``, ``temps`` and
    ``top_ps`` host sequences of n.  The lm_head runs on each prompt's last
    row only."""
    h, _ = L.forward(params, ids, cfg, cache=cache_n, start_pos=0, return_hidden=True, mesh=mesh)
    n = len(true_lens)
    last_rows = torch.tensor([int(t) - 1 for t in true_lens], device=h.device)
    last = L.lm_logits(params, h[torch.arange(n, device=h.device), last_rows])  # [n, V]
    if not sampling:
        return last.argmax(dim=-1)
    dev = last.device
    return _sample_tokens(
        last, torch.tensor(np.asarray(temps, np.float32), device=dev),
        torch.tensor(np.asarray(top_ps, np.float32), device=dev), generator, pool,
    )


def _bucket(n: int, lo: int = 16) -> int:
    """Powers of 4 from ``lo``: few distinct prefill lengths, at up to 4x
    padding (the JAX package's buckets, which bound its compiled programs)."""
    b = lo
    while b < n:
        b *= 4
    return b


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, QuantizedTensor):
        yield tree.data
    elif isinstance(tree, Int8TensorState):
        yield tree.CB
        yield tree.SCB
    elif isinstance(tree, Sharded):
        yield from _tensors(tree.local)
    elif isinstance(tree, torch.Tensor):
        yield tree


class ContinuousBatchingEngine:
    """Host-side request scheduler around prefill and chunked decode.

    Usage::

        eng = ContinuousBatchingEngine(params, cfg, max_batch=8, max_len=512)
        eng.add_request([1, 2, 3], max_new_tokens=32)
        while eng.has_work():
            for r in eng.step():
                print(r.tokens)
    """

    def __init__(
        self,
        params: Any,
        cfg: L.LlamaConfig,
        max_batch: int = 8,
        max_len: int = 1024,
        kv_dtype: str = "bf16",
        eos_id: Optional[int] = None,
        steps_per_sync: int = 8,
        mesh=None,
        seed: int = 0,
        sampling_pool: Optional[int] = _DEFAULT_POOL,
        kv_layout: str = "dense",
        kv_block_size: int = 128,
        num_kv_blocks: Optional[int] = None,
        pipeline_depth: int = 2,
        device=None,
    ):
        """``sampling_pool``: size of the top-k candidate set for
        temperature/top-p sampling (:func:`_sample_tokens`); ``None`` means
        the whole vocabulary (exact nucleus sampling at any temperature).

        ``kv_layout="paged"`` keeps KV in a pool of ``num_kv_blocks`` blocks
        of ``kv_block_size`` tokens (default: the dense equivalent).
        Admissions that cannot get blocks wait in the queue; a pool that
        runs dry mid-decode preempts the youngest slot back to the queue
        (raising only when a single request alone can never fit).

        ``pipeline_depth``: decode chunks in flight before the host blocks
        on the oldest (1 = dispatch then sync).  Retirement and admission
        lag by ``depth - 1`` chunks; greedy streams are the same at every
        depth.

        ``device``: where the engine runs, CUDA unless named; ``params``
        must lie there.

        ``mesh``: a ``parallel.Mesh`` over initialized process groups, with
        a ``model`` axis (and optionally ``data``), serves over several
        ranks, one engine a rank driven with the same requests.  As in the
        JAX package, the params are split by ``parallel.llama_param_specs``
        and the cache by ``parallel.shard_kv_cache`` (a dense cache's slots
        over ``data`` and KV heads over ``model``; a pool's KV heads), and
        prefill and decode run ``models/llama.forward(mesh=)``.  Every rank
        computes the same logits and draws from the same seeds, so every
        rank's streams are the same.  Prefills run over the mesh without its
        ``data`` axis, through a temporary cache of the prompts' rows, and
        each rank copies the rows of its own slots out of it."""
        if mesh is not None and (not isinstance(mesh, Mesh) or mesh.virtual):
            raise TypeError("mesh must be a parallel.Mesh over process groups (parallel.make_mesh)")
        self.device = resolve_device(device)
        for t in _tensors(params):
            d = t.device
            if d.type != self.device.type or (self.device.index is not None and d.index != self.device.index):
                raise ValueError(f"params lie on {d}, the engine runs on {self.device}")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        if kv_layout not in ("dense", "paged"):
            raise ValueError("kv_layout must be 'dense' or 'paged'")
        self.kv_layout = kv_layout
        self.kv_block_size = kv_block_size
        if kv_layout == "paged":
            # prefill packs whole blocks out of the padded prompt, and decode
            # grows tables in whole blocks up to max_len
            if kv_block_size < 8 or kv_block_size & (kv_block_size - 1):
                raise ValueError("kv_block_size must be a power of two >= 8")
            if max_len % kv_block_size:
                raise ValueError(
                    f"max_len ({max_len}) must be a multiple of kv_block_size ({kv_block_size}) "
                    "for kv_layout='paged'"
                )
            max_blocks_per_slot = max_len // kv_block_size
            if num_kv_blocks is None:
                num_kv_blocks = max_batch * max_blocks_per_slot
            self.num_kv_blocks = num_kv_blocks
            # one extra "trash" block takes the decode writes of inactive
            # slots (parked at position 0), so they never touch live blocks
            self._trash_block = num_kv_blocks
            self._free_blocks = list(range(num_kv_blocks - 1, -1, -1))
            self._tables = np.full((max_batch, max_blocks_per_slot), self._trash_block, np.int32)
            self._slot_blocks: Dict[int, List[int]] = {}
            cache = L.init_paged_kv_cache(cfg, max_batch, max_len, num_kv_blocks + 1, kv_block_size, kv_dtype,
                                          device=self.device)
            cache = cache._replace(tables=torch.tensor(self._tables, device=self.device))
        else:
            cache = L.init_kv_cache(cfg, max_batch, max_len, kv_dtype=kv_dtype, device=self.device)
        self.mesh = mesh
        self._prefill_mesh = None
        self._slot_range = range(max_batch)  # the slots this rank's dense cache holds
        if mesh is not None:
            params = llama_param_specs(mesh, params)
            cache = shard_kv_cache(cache, mesh)
            self._prefill_mesh = mesh.sub([a for a in mesh.axis_names if a != "data"])
            if kv_layout == "dense":
                da = tp_axes(mesh, cfg.num_kv_heads, max_batch)[0]
                if da is not None:
                    n = max_batch // mesh.axis_size(da)
                    self._slot_range = range(mesh.index(da) * n, (mesh.index(da) + 1) * n)
        self.params = params
        self.cache = cache
        self.kv_dtype = kv_dtype
        self.lengths = np.zeros(max_batch, np.int32)  # committed tokens in the cache
        # dispatch-side positions: ahead of ``lengths`` by the chunks in flight
        self._disp_lengths = np.zeros(max_batch, np.int32)
        self.slots: Dict[int, _Slot] = {}
        # slot -> 0-d device tensor: first tokens of admitted requests, merged
        # into the next chunk's input on the device and fetched with it
        self._first_pending: Dict[int, torch.Tensor] = {}
        # chunks dispatched but not yet read: (fetch [S(+1), B] on the device,
        # with the input row first when first tokens are pending; pend
        # [(slot, request id, first)]; {slot: request id at dispatch}, which
        # guards attribution when a slot is retired and re-admitted meanwhile)
        self._inflight: Deque[Tuple[torch.Tensor, list, Dict[int, int]]] = deque()
        # the previous chunk's last tokens, on the device: the next chunk's input
        self._last_out: Optional[torch.Tensor] = None
        self.pipeline_depth = max(1, int(pipeline_depth))
        # device copies of the dispatch inputs, uploaded again only when the
        # slot set changes
        self._slots_dirty = True
        self._tables_dirty = True
        self._positions_dev: Optional[torch.Tensor] = None
        self._active_dev: Optional[torch.Tensor] = None
        self._temps_dev: Optional[torch.Tensor] = None
        self._topps_dev: Optional[torch.Tensor] = None
        self.temps = np.zeros(max_batch, np.float32)
        self.top_ps = np.ones(max_batch, np.float32)
        self._step_count = 0
        self.seed = int(seed)
        self._gen = torch.Generator(device=self.device)
        self._next_id = 0
        self._pending: List[_Slot] = []
        self._admit_seq = 0
        # results completed inside a preemption drain, returned by the next step()
        self._drained: List[GenerationResult] = []
        self.preempt_count = 0  # slots evicted by _preempt
        self.sampling_pool = min(sampling_pool if sampling_pool is not None else cfg.vocab_size, cfg.vocab_size)
        self.steps_per_sync = max(1, steps_per_sync)

    def _generator(self, *tags: int) -> torch.Generator:
        return self._gen.manual_seed(_seed(self.seed, *tags))

    # -- request management -------------------------------------------------

    def add_request(self, prompt_ids: List[int], max_new_tokens: int = 64, temperature: float = 0.0,
                    top_p: float = 1.0) -> int:
        rid = self._next_id
        self._next_id += 1
        if len(prompt_ids) >= self.max_len:
            raise ValueError("prompt longer than max_len")
        if self.kv_layout == "paged":
            need = min(self._blocks_needed(len(prompt_ids) + self.steps_per_sync),
                       self.max_len // self.kv_block_size)
            if need > self.num_kv_blocks:
                # it would wait in the queue forever
                raise ValueError(
                    f"prompt needs {need} KV blocks through its first decode chunk but the pool only "
                    f"has {self.num_kv_blocks}"
                )
        self._pending.append(
            _Slot(rid, [int(t) for t in prompt_ids], max_new_tokens, temperature, top_p,
                  submit_t=time.monotonic())
        )
        # admitted at the next step(), where queued bursts group into one prefill
        return rid

    def _free_slots(self) -> List[int]:
        return [b for b in range(self.max_batch) if b not in self.slots]

    def _blocks_needed(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.kv_block_size)

    def _admit(self) -> None:
        """Admit pending requests into free slots.  Prefills are dispatched
        and their first tokens stay on the device, merged into the next
        decode chunk's input and fetched with it.  With a paged cache a
        request waits until the pool has blocks for its prompt and its first
        decode chunk."""
        free = self._free_slots()
        batch: List[Tuple[int, _Slot]] = []
        avail = len(self._free_blocks) if self.kv_layout == "paged" else 0
        while free and self._pending:
            if self.kv_layout == "paged":
                # reserve through the first decode chunk, which grows the
                # tables to lengths + steps_per_sync
                n_ids = len(self._pending[0].prefill_ids)
                need = min(self._blocks_needed(n_ids + self.steps_per_sync), self._tables.shape[1])
                if need > avail:
                    if not self.slots and not self._inflight and not batch:
                        # nothing live can free a block again: the request
                        # alone exceeds the pool (a preempted request can
                        # grow past add_request's check)
                        raise RuntimeError(
                            f"request {self._pending[0].request_id} needs {need} KV blocks but the pool "
                            f"has {self.num_kv_blocks}; raise num_kv_blocks or lower max_new_tokens"
                        )
                    break  # backpressure: wait for retirements
                avail -= self._blocks_needed(n_ids)
            req = self._pending.pop(0)
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            batch.append((free.pop(0), req))
        if not batch:
            return
        # same-pad admissions prefill as one batched forward
        groups: Dict[int, List[Tuple[int, _Slot]]] = {}
        for b, req in batch:
            groups.setdefault(self._prefill_pad(len(req.prefill_ids)), []).append((b, req))
        for pad, grp in sorted(groups.items()):
            self._prefill_group(pad, grp)

    def _prefill_pad(self, n_ids: int) -> int:
        pad = _bucket(n_ids)
        if self.kv_layout == "paged":
            pad = max(pad, self.kv_block_size)  # whole blocks, so the prefill packs cleanly
        return min(pad, self.max_len)

    def _prefill_group(self, pad_len: int, grp: List[Tuple[int, _Slot]]) -> None:
        """Prefill one or more same-pad requests as one batched forward
        (where the JAX package has a second, single-request program).
        Unlike the JAX package, the batch is not padded to a bucket of rows:
        there is no compiled program to reuse.  Positions past a prompt hold
        K/V of the padding, which its length masks at decode.  Sampled first
        tokens draw from a generator seeded by the first request."""
        n = len(grp)
        ids_p = np.zeros((n, pad_len), np.int64)
        for i, (_, req) in enumerate(grp):
            ids_p[i, : len(req.prefill_ids)] = req.prefill_ids
        slots = [b for b, _ in grp]
        split_slots = len(self._slot_range) != self.max_batch  # a dense cache split over data
        if self.kv_layout == "paged" or split_slots:
            cache_n = L.init_kv_cache(self.cfg, n, pad_len if self.kv_layout == "paged" else self.max_len,
                                      kv_dtype=self.kv_dtype, device=self.device)
            if self.mesh is not None:
                cache_n = shard_kv_cache(cache_n, self._prefill_mesh)
        else:
            idx = torch.tensor(slots, device=self.device)
            cache_n = type(self.cache)(*(t.index_select(1, idx) for t in self.cache))
        nxt = _prefill_batch(
            self.params, cache_n, torch.tensor(ids_p, device=self.device),
            [len(r.prefill_ids) for _, r in grp], [r.temperature for _, r in grp], [r.top_p for _, r in grp],
            self._generator(_PREFILL, grp[0][1].request_id), cfg=self.cfg,
            sampling=any(r.temperature > 0 for _, r in grp), pool=self.sampling_pool, mesh=self._prefill_mesh,
        )
        if self.kv_layout == "paged":
            for i, (b, req) in enumerate(grp):
                self._pack_slot_blocks(b, len(req.prefill_ids), cache_n, row=i)
        elif split_slots:
            mine = [(i, b - self._slot_range.start) for i, b in enumerate(slots) if b in self._slot_range]
            if mine:
                rows = torch.tensor([i for i, _ in mine], device=self.device)
                local = torch.tensor([j for _, j in mine], device=self.device)
                for big, many in zip(self.cache, cache_n):
                    big.index_copy_(1, local, many.index_select(1, rows))
        else:
            for big, many in zip(self.cache, cache_n):
                big.index_copy_(1, idx, many)
        for i, (b, req) in enumerate(grp):
            self.lengths[b] = self._disp_lengths[b] = len(req.prefill_ids)
            self.slots[b] = req
            self.temps[b] = req.temperature
            self.top_ps[b] = req.top_p
            self._first_pending[b] = nxt[i]
        self._slots_dirty = True

    def _pack_slot_blocks(self, b: int, prompt_len: int, cache_n, row: int) -> None:
        """Allocate blocks for slot ``b``'s prompt and copy row ``row`` of a
        prefilled dense cache into them, codes and scales alike."""
        BS = self.kv_block_size
        nb = self._blocks_needed(prompt_len)
        blk_ids = [self._free_blocks.pop() for _ in range(nb)]
        self._slot_blocks[b] = blk_ids
        self._tables[b, :] = blk_ids[-1]  # filler past the live blocks
        self._tables[b, :nb] = blk_ids
        self._tables_dirty = True
        ids_dev = torch.tensor(blk_ids, device=self.device)
        pools = (self.cache.k, self.cache.v, self.cache.k_scale, self.cache.v_scale)
        for pool, one in zip(pools, cache_n):
            if pool is None:
                continue
            sl = one[:, row]  # [L, KVH, pad_len(, hd)]
            blocks = sl[:, :, : nb * BS].reshape(sl.shape[0], sl.shape[1], nb, BS, *sl.shape[3:])
            pool.index_copy_(1, ids_dev, blocks.transpose(1, 2))  # [L, nb, KVH, BS(, hd)]

    def has_work(self) -> bool:
        return bool(self.slots) or bool(self._pending) or bool(self._inflight)

    def _retire(self, b: int) -> None:
        del self.slots[b]
        self.lengths[b] = 0
        self._disp_lengths[b] = 0
        self.temps[b] = 0.0
        self.top_ps[b] = 1.0
        self._slots_dirty = True
        if self.kv_layout == "paged":
            # return the slot's blocks; park its table on the trash block.  A
            # later prefill may reuse them at once: the stream runs it after
            # the decode chunks already dispatched.
            self._free_blocks.extend(self._slot_blocks.pop(b))
            self._tables[b, :] = self._trash_block
            self._tables_dirty = True

    # -- decode -------------------------------------------------------------

    def step(self) -> List[GenerationResult]:
        """Dispatch one decode chunk (if a slot is live) and read the oldest
        chunk in flight once ``pipeline_depth`` are.  Returns the requests
        that finished."""
        self._admit()
        if not self.slots and not self._inflight:
            out, self._drained = self._drained, []
            return out
        if self.slots:
            self._dispatch_chunk()
        finished: List[GenerationResult] = []
        if self._drained:
            finished.extend(self._drained)
            self._drained = []
        # keep depth-1 chunks in flight while slots are live; drain when none is
        keep = self.pipeline_depth - 1 if self.slots else 0
        while len(self._inflight) > keep:
            finished.extend(self._process_oldest())
        self._admit()
        return finished

    def _ensure_blocks(self) -> None:
        """Before a paged chunk: when its block demand exceeds the free pool,
        drain the pipeline and preempt the youngest slots (recompute
        preemption): each is re-queued at the front with its generated
        tokens as a prefill prefix, so greedy streams do not change."""
        if self.kv_layout != "paged":
            return

        def deficit() -> int:
            need = 0
            for b in self.slots:
                n = min(self._blocks_needed(int(self._disp_lengths[b]) + self.steps_per_sync), self._tables.shape[1])
                need += max(0, n - len(self._slot_blocks[b]))
            return need - len(self._free_blocks)

        if deficit() <= 0:
            return
        # drain first: chunks in flight may retire slots, and a victim's
        # whole stream must be on the host
        while self._inflight:
            self._drained.extend(self._process_oldest())
        while deficit() > 0 and self.slots:
            if len(self.slots) == 1:
                # the last slot alone outgrows the pool: requeue it too;
                # _admit raises if it can never fit
                self._preempt(next(iter(self.slots)))
                break
            self._preempt(max(self.slots, key=lambda b: self.slots[b].admit_seq))

    def _preempt(self, b: int) -> None:
        """Evict slot ``b``: free its blocks and re-queue the request at the
        front, to resume from its generated tokens."""
        req = self.slots[b]
        self.preempt_count += 1
        if b in self._first_pending:
            # prefilled, but its first token never joined a chunk: fetch it
            # now (one sync, on a rare path)
            tok = int(self._first_pending.pop(b))
            req.first_t = req.first_t or time.monotonic()
            req.tokens.append(tok)
            done_eos = self.eos_id is not None and tok == self.eos_id
            if done_eos or len(req.tokens) >= req.max_new_tokens:
                self._drained.append(self._result(req, "eos" if done_eos else "length"))
                self._retire(b)
                return
        self._retire(b)
        self._pending.insert(
            0,
            _Slot(req.request_id, req.prompt, req.max_new_tokens, req.temperature, req.top_p,
                  tokens=list(req.tokens), submit_t=req.submit_t, first_t=req.first_t),
        )

    def _dispatch_chunk(self) -> None:
        """Dispatch one decode chunk for every live slot, with no host sync:
        the input tokens chain on the device from the previous chunk's
        output, with pending first tokens merged in."""
        self._ensure_blocks()
        if not self.slots:
            return  # everything was preempted back to the queue
        dev = self.device
        active = np.zeros(self.max_batch, bool)
        active[list(self.slots)] = True
        if self.kv_layout == "paged":
            # grow tables so every live slot's blocks cover the whole chunk
            for b in self.slots:
                need = min(self._blocks_needed(int(self._disp_lengths[b]) + self.steps_per_sync),
                           self._tables.shape[1])
                have = len(self._slot_blocks[b])
                grew = have < need
                while have < need:
                    assert self._free_blocks, "grow after _ensure_blocks"
                    nb = self._free_blocks.pop()
                    self._slot_blocks[b].append(nb)
                    self._tables[b, have] = nb
                    have += 1
                if grew:
                    self._tables[b, have:] = self._tables[b, have - 1]  # filler past the live blocks
                    self._tables_dirty = True
            if self._tables_dirty:
                self.cache = self.cache._replace(tables=torch.tensor(self._tables, device=dev))
                self._tables_dirty = False
        if self._slots_dirty:
            positions = torch.tensor(np.where(active, self._disp_lengths, 0).astype(np.int64), device=dev)
            self._active_dev = torch.tensor(active.astype(np.int64), device=dev)
            self._temps_dev = torch.tensor(self.temps, device=dev)
            self._topps_dev = torch.tensor(self.top_ps, device=dev)
            self._slots_dirty = False
        else:
            # the same slots as the last chunk: each advanced S positions
            positions = self._positions_dev + self.steps_per_sync * self._active_dev
        self._positions_dev = positions
        tokens = self._last_out if self._last_out is not None else torch.zeros(
            self.max_batch, dtype=torch.int64, device=dev)
        pend = [(b, self.slots[b].request_id, t) for b, t in sorted(self._first_pending.items())]
        self._first_pending.clear()
        if pend:
            idxs = torch.tensor([b for b, _, _ in pend], device=dev)
            tokens = tokens.index_put((idxs,), torch.stack([t for _, _, t in pend]))
        gen = self._generator(_DECODE, self._step_count)
        self._step_count += 1
        chunk = _decode_chunk(
            self.params, self.cache, tokens, positions, self._temps_dev, self._topps_dev, gen,
            cfg=self.cfg, S=self.steps_per_sync, sampling=bool((self.temps > 0).any()), pool=self.sampling_pool,
            mesh=self.mesh,
        )
        self._last_out = chunk[-1]
        self._disp_lengths[active] += self.steps_per_sync
        smap = {b: self.slots[b].request_id for b in self.slots}
        # with first tokens pending, the input row goes first: one fetch reads both
        fetch = torch.cat([tokens[None], chunk], dim=0) if pend else chunk
        self._inflight.append((fetch, pend, smap))

    @staticmethod
    def _result(req: _Slot, reason: str) -> GenerationResult:
        now = time.monotonic()
        return GenerationResult(
            request_id=req.request_id, prompt=req.prompt, tokens=req.tokens, finished_reason=reason,
            ttft_s=(req.first_t or now) - req.submit_t, total_s=now - req.submit_t,
        )

    def _process_oldest(self) -> List[GenerationResult]:
        """Read the oldest chunk in flight (one fetch), append its tokens to
        their requests and retire the finished ones.  Tokens go to a slot
        only if it still holds the request it held at dispatch."""
        fetch_dev, pend, smap = self._inflight.popleft()
        arr = fetch_dev.cpu().numpy()  # the one sync: first tokens and chunk
        chunk = arr[1:] if pend else arr  # [S, B]
        finished: List[GenerationResult] = []
        dead_on_first = set()
        for b, rid, _ in pend:
            req = self.slots.get(b)
            if req is None or req.request_id != rid:
                continue
            tok = int(arr[0, b])
            req.first_t = time.monotonic()
            req.tokens.append(tok)
            done_eos = self.eos_id is not None and tok == self.eos_id
            done_len = len(req.tokens) >= req.max_new_tokens or self.lengths[b] + 1 >= self.max_len
            if done_eos or done_len:
                dead_on_first.add(b)
                finished.append(self._result(req, "eos" if done_eos else "length"))

        for b, rid in smap.items():
            req = self.slots.get(b)
            if req is None or req.request_id != rid:
                continue  # retired (and perhaps re-admitted) since dispatch
            if b in dead_on_first:
                # finished on its first token: this chunk's tokens are
                # speculative, discard them
                self._retire(b)
                continue
            done_eos = done_len = False
            for s in range(chunk.shape[0]):
                tok = int(chunk[s, b])
                req.tokens.append(tok)
                self.lengths[b] += 1
                done_eos = self.eos_id is not None and tok == self.eos_id
                done_len = len(req.tokens) >= req.max_new_tokens or self.lengths[b] + 1 >= self.max_len
                if done_eos or done_len:
                    break
            if done_eos or done_len:
                finished.append(self._result(req, "eos" if done_eos else "length"))
                self._retire(b)
        return finished

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 64, temperature: float = 0.0,
                 top_p: float = 1.0) -> List[GenerationResult]:
        """Submit all prompts and run to completion; results by request id."""
        for p in prompts:
            self.add_request(p, max_new_tokens, temperature=temperature, top_p=top_p)
        out: List[GenerationResult] = []
        while self.has_work():
            out.extend(self.step())
        return sorted(out, key=lambda r: r.request_id)
