"""The port's MoE layer (``models/moe.py``) against a composition of the
JAX package's own functions, on the CPU.

The JAX package's ``moe_ffn`` reads its paired experts as flat (its
``_expert_ffn`` rebuilds each state with ``QuantState.make``, whose layout
defaults to ``"flat"``), so the reference here is built from JAX functions
alone with the layout the experts were quantized in: ``_gates``, then each
expert's ``autograd.matmul_4bit`` on a ``QuantState.make(..., layout=
"paired")`` of its own slices.  Expert parallelism runs in
``tests/test_torch_parallel.py``'s spawned ranks."""

import numpy as np
import pytest
import torch

from bitsandbytes_tpu_torch.models import moe as TM
from bitsandbytes_tpu_torch.utils.interop import moe_params_from_numpy

torch.set_num_threads(1)

E, HIDDEN, FFN = 4, 256, 256
TOL = {"float32": dict(atol=0.01, rtol=0.01), "bfloat16": dict(atol=0.03, rtol=0.05)}


@pytest.fixture(scope="module")
def layer():
    import jax
    import jax.numpy as jnp
    from bitsandbytes_tpu.models import moe as JM

    jp, jmeta = JM.init_moe_params(jax.random.PRNGKey(0), hidden=HIDDEN, ffn=FFN, n_experts=E)
    tp, tmeta = moe_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, jmeta, "cpu")
    x = jax.random.normal(jax.random.PRNGKey(1), (8, HIDDEN), jnp.float32)
    return jp, jmeta, tp, tmeta, x


def _composition(jp, jmeta, x, top_k):
    """The MoE computed from JAX functions, each expert on its paired layout."""
    import jax
    import jax.numpy as jnp
    from bitsandbytes_tpu import autograd as JA
    from bitsandbytes_tpu.functional.quant_state import QuantState as JQS
    from bitsandbytes_tpu.models import moe as JM

    gates = JM._gates(x, jp["router"], top_k)

    def mm(a, name, e):
        qt, bs, shape = jmeta[name]
        st = JQS.make(absmax=jp[name + "_absmax"][e], shape=shape, quant_type=qt, blocksize=bs, dtype=a.dtype,
                      layout="paired")
        return JA.matmul_4bit(a, jp[name + "_data"][e], st)

    out = jnp.zeros((x.shape[0], x.shape[-1]), jnp.float32)
    for e in range(E):
        g, u = jnp.split(mm(x, "gate_up", e), 2, axis=-1)
        h = (jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32)).astype(x.dtype)
        out = out + gates[:, e : e + 1] * mm(h, "down", e).astype(jnp.float32)
    return np.asarray(out.astype(x.dtype).astype(jnp.float32)), np.asarray(gates)


def _port_x(x):
    return torch.from_numpy(np.array(x.astype("float32"))).to(
        torch.bfloat16 if x.dtype.name == "bfloat16" else torch.float32)


def test_carried_layouts_are_the_quantizers():
    """moe_params_from_numpy records each weight's layout from its payload."""
    import jax
    from bitsandbytes_tpu.models import moe as JM

    jp, jmeta = JM.init_moe_params(jax.random.PRNGKey(0), hidden=HIDDEN, ffn=FFN, n_experts=2)
    _, tmeta = moe_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, jmeta, "cpu")
    assert tmeta == {"gate_up": ("nf4", 64, (2 * FFN, HIDDEN), "paired"), "down": ("nf4", 64, (HIDDEN, FFN), "paired")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2, E])
def test_moe_ffn_matches_jax_composition(layer, dtype, top_k):
    """The port's moe_ffn against the corrected JAX composition; the gates
    keep the same experts as ``_gates`` and agree with its f32 values
    within two units in the last place (the port rounds f64 gates once)."""
    jp, jmeta, tp, tmeta, x = layer
    xj = x.astype(dtype)
    ref, gates = _composition(jp, jmeta, xj, top_k)
    xt = _port_x(xj)
    out = TM.moe_ffn(tp, tmeta, xt, top_k=top_k)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    np.testing.assert_allclose(out.float().numpy(), ref, **TOL[dtype])
    tg = TM.moe_gates(xt, tp["router"], top_k).numpy()
    np.testing.assert_array_equal(tg > 0, gates > 0)
    np.testing.assert_allclose(tg, gates, rtol=2.4e-7, atol=1.2e-7)


def test_gates_mask_ties_like_jax():
    """Logits tied with the k-th stay, as ``_gates`` keeps them."""
    x = torch.tensor([[1.0, 0.0]])
    router = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    g = TM.moe_gates(x, router, 1)
    assert (g[0, :2] > 0).all() and g[0, 2] == 0
    torch.testing.assert_close(g[0, :2].sum(), torch.tensor(1.0))


def test_jax_moe_ffn_reads_paired_experts_as_flat(layer):
    """Records the reference's fault: the JAX package's own moe_ffn (its
    paired experts read as flat) is far from the same experts on their own
    layout, while the port stays within tolerance of them."""
    import jax.numpy as jnp
    from bitsandbytes_tpu.models import moe as JM

    jp, jmeta, tp, tmeta, x = layer
    ref, _ = _composition(jp, jmeta, x, 2)
    jax_out = np.asarray(JM.moe_ffn(jp, jmeta, x, top_k=2).astype(jnp.float32))
    port = TM.moe_ffn(tp, tmeta, _port_x(x), top_k=2).numpy()
    assert np.abs(jax_out - ref).max() > 1.0 > 0.01 > np.abs(port - ref).max()


def test_init_moe_params_tree_and_meta():
    """The port's own init: the JAX package's keys and shapes, f32 router,
    paired experts, seeded."""
    g = torch.Generator().manual_seed(0)
    params, meta = TM.init_moe_params(128, 64, 4, generator=g, device="cpu")
    assert params["router"].dtype == torch.float32 and params["router"].shape == (4, 128)
    assert params["gate_up_data"].shape == (4, 64, 128) and params["gate_up_absmax"].shape == (4, 2, 128)
    assert params["down_data"].shape == (4, 64, 64) and params["down_absmax"].shape == (4, 1, 128)
    assert meta["gate_up"] == ("nf4", 64, (128, 128), "paired") and meta["down"][3] == "paired"
    again, _ = TM.init_moe_params(128, 64, 4, generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)
    x = torch.randn(5, 128, generator=g, dtype=torch.float32).to(torch.bfloat16)
    out = TM.moe_ffn(params, meta, x, top_k=2)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()


def test_expert_parallel_refuses_uneven_split():
    from bitsandbytes_tpu_torch.parallel import make_mesh

    params, meta = TM.init_moe_params(128, 64, 3, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="do not shard"):
        TM.moe_ffn_expert_parallel(params, meta, torch.zeros(2, 128), make_mesh({"expert": 2}, coord=0))
