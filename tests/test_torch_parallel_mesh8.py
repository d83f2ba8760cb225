"""One QLoRA step over the 8-rank ``{"data": 2, "seq": 2, "model": 2}``
mesh that ``__graft_entry__.dryrun_multichip`` builds for 8 devices: the
port in 8 gloo ranks against the JAX package's step jitted over 8 of its CPU
devices, on the CPU.

The ranks hold the tiny Llama's NF4 tree split over "model"
(``llama_param_specs``), the batch over "data" and the tokens over "seq"
(ids ``[4, 32]``: 31 input tokens, so the last "seq" rank's shard ends in a
padding token, as GSPMD pads the uneven split).  They run one
``lora_train_step`` with ``adamw8bit`` on the bf16 model, whose loss is held
against the JAX step's, and the loss and gradients of the f32 model, held
against the meshless port's step (the contract of
``test_torch_parallel_train.py``: bf16 models to the loss, f32 ones to the
gradients).  The world spawns once and has a time limit of its own; its
ranks import neither JAX nor the JAX package."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bitsandbytes_tpu_torch import optim as TO
from bitsandbytes_tpu_torch import parallel as TP
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.utils.interop import lora_from_numpy, params_from_numpy
from torch_ranks import spawn_world

torch.set_num_threads(1)

AXES = {"data": 2, "seq": 2, "model": 2}
WORLD = 8
WORLD_LIMIT_S = 150
IDS_SHAPE = (4, 32)  # dryrun_multichip's: batch 2 x data, 16 x seq tokens
TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def _np_tree(tree):
    """A JAX tree -> nested dicts/lists of numpy (``params_from_numpy``'s input)."""
    import jax.numpy as jnp
    from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT

    if isinstance(tree, JQT):
        st = tree.state
        d = {"data": np.asarray(tree.data), "absmax": np.asarray(st.absmax), "shape": tuple(st.shape),
             "blocksize": st.blocksize, "quant_type": st.quant_type, "layout": st.layout,
             "code": np.asarray(st.code), "dtype": jnp.dtype(st.dtype).name}
        if st.nested:
            d.update(offset=np.asarray(st.offset), nested_absmax=np.asarray(st.state2.absmax),
                     nested_blocksize=st.state2.blocksize, nested_code=np.asarray(st.state2.code))
        return d
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def case():
    """The tiny Llama, its adapters and ids made by the JAX package, and the
    loss of its training step jitted over the 8-device mesh as
    ``dryrun_multichip`` builds it (params split by ``llama_param_specs``,
    the adapters replicated, ids split over data and seq)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bitsandbytes_tpu import optim as JO
    from bitsandbytes_tpu import parallel as JP
    from bitsandbytes_tpu.models import llama as JL

    jcfg = JL.LlamaConfig.tiny()
    jcfg32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    q16 = JL.quantize_params_4bit(JL.init_params(jax.random.PRNGKey(0), jcfg), quant_type="nf4")
    q32 = JL.quantize_params_4bit(JL.init_params(jax.random.PRNGKey(0), jcfg32), quant_type="nf4")
    jlora = JL.add_lora(jax.random.PRNGKey(1), jcfg, rank=4, targets=TARGETS)
    rng = np.random.default_rng(0)
    for layer in jlora["layers"]:  # b drawn small: every adapter tensor gets a gradient
        for ad in layer.values():
            ad["b"] = jnp.asarray((rng.standard_normal(ad["b"].shape) * 0.02).astype(np.float32))
    ids = jax.random.randint(jax.random.PRNGKey(2), IDS_SHAPE, 0, jcfg.vocab_size)

    mesh = JP.make_mesh(AXES)
    optimizer = JO.adamw8bit(1e-3)
    lora = JP.shard_quantized_tree(jlora, mesh, lambda path, leaf: P())

    @jax.jit
    def train_step(params, lora, opt_state, ids):
        return JL.lora_train_step(params, lora, opt_state, ids, jcfg, optimizer)

    with jax.sharding.use_mesh(mesh) if hasattr(jax.sharding, "use_mesh") else mesh:
        loss, _, _ = train_step(JP.llama_param_specs(mesh, q16), lora, optimizer.init(lora),
                                jax.device_put(ids, NamedSharding(mesh, P("data", "seq"))))
    return {"cfg": TL.LlamaConfig.tiny(), "params16": params_from_numpy(_np_tree(q16), "cpu"),
            "params32": params_from_numpy(_np_tree(q32), "cpu"), "lora": _np_tree(jlora),
            "ids": torch.from_numpy(np.array(ids)).to(torch.int64), "jax_loss": float(loss)}


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of the 8: the step and the f32 gradients, written to ``out{rank}.pt``."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        cfg, ids = inp["cfg"], inp["ids"]
        mesh = TP.make_mesh(AXES)
        lora = lora_from_numpy(inp["lora"], "cpu")
        opt = TO.adamw8bit(TL.lora_parameters(lora), 1e-3, min_8bit_size=1024)
        out = {"coord": mesh.coord}
        out["step_loss"] = TL.lora_train_step(TP.llama_param_specs(mesh, inp["params16"]), lora, opt, ids, cfg,
                                              mesh=mesh)
        out["summed_grads"] = [t.grad.clone() for t in TL.lora_parameters(lora)]
        out["adapters"] = [t.detach().clone() for t in TL.lora_parameters(lora)]
        out["states"] = [{k: v.clone() for k, v in opt.state[t].items() if isinstance(v, torch.Tensor)}
                         for t in TL.lora_parameters(lora)]
        lora = lora_from_numpy(inp["lora"], "cpu")
        loss = TL.lm_loss(TP.llama_param_specs(mesh, inp["params32"]), lora, ids,
                          dataclasses.replace(cfg, dtype=torch.float32), mesh=mesh)
        loss.backward()
        out["loss32"] = loss.detach()
        out["grads32"] = [t.grad.clone() for t in TL.lora_parameters(lora)]  # this rank's share
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh8"))
    torch.save({k: v for k, v in case.items() if not k.startswith("jax")}, os.path.join(tmp, "inputs.pt"))
    spawn_world(_rank_main, WORLD, tmp, WORLD_LIMIT_S)
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False) for r in range(WORLD)]


def test_step_loss_matches_the_jax_step_over_8_devices(ranks, case):
    """The step's loss (bf16 model) is the same bits on every rank and within
    rel 1e-3 of the JAX package's step jitted over its 8-device mesh and of
    the meshless port's loss on the same ids."""
    for o in ranks[1:]:
        assert torch.equal(o["step_loss"], ranks[0]["step_loss"]), o["coord"]
    loss = float(ranks[0]["step_loss"])
    with torch.no_grad():
        meshless = TL.lm_loss(case["params16"], lora_from_numpy(case["lora"], "cpu"), case["ids"], case["cfg"]).item()
    for ref in (case["jax_loss"], meshless):
        assert abs(loss - ref) <= 1e-3 * abs(ref), (loss, ref)


def test_gradients_match_the_meshless_step(ranks, case):
    """On the f32 model the ranks' gradient shares of one model coordinate
    add up, over data and seq, within rtol 2e-2 / atol 2e-3 of the meshless
    port's gradients, the shares are the same over "model", and the loss is
    within rel 1e-3 of the meshless one."""
    cfg32 = dataclasses.replace(case["cfg"], dtype=torch.float32)
    lora = lora_from_numpy(case["lora"], "cpu")
    loss = TL.lm_loss(case["params32"], lora, case["ids"], cfg32)
    loss.backward()
    assert abs(float(ranks[0]["loss32"]) - loss.item()) <= 1e-3 * abs(loss.item())
    by_coord = {tuple(o["coord"][a] for a in ("data", "seq", "model")): o for o in ranks}
    for (d, s, m), o in by_coord.items():
        assert all(torch.equal(a, b) for a, b in zip(o["grads32"], by_coord[(d, s, 0)]["grads32"])), (d, s, m)
    shares = [o["grads32"] for (d, s, m), o in by_coord.items() if m == 0]
    for i, t in enumerate(TL.lora_parameters(lora)):
        np.testing.assert_allclose(sum(g[i] for g in shares).numpy(), t.grad.numpy(), rtol=2e-2, atol=2e-3,
                                   err_msg=f"leaf {i}")


def test_replicas_stay_equal_after_the_step(ranks):
    """After the ``adamw8bit`` step the summed gradients, the adapters and
    every optimizer state are the same bits on all 8 ranks, some states in
    8 bits."""
    first = ranks[0]
    assert any(st.get("state1") is not None and st["state1"].dtype == torch.uint8 for st in first["states"])
    for o in ranks[1:]:
        for key in ("summed_grads", "adapters"):
            assert all(torch.equal(a, b) for a, b in zip(o[key], first[key])), (key, o["coord"])
        for sa, sb in zip(o["states"], first["states"]):
            assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa), o["coord"]
