"""The committed trained checkpoint (``tests/fixtures/quality_lm.*``, a 13.9 M
parameter Llama in the JAX package's tree names, bf16) through the port's
loader, against the JAX package's, on the CPU.

Both packages load it onto their ``init_params`` template and hold
bit-identical trees; the port's safetensors reader gives what
``safetensors.torch.load_file`` gives.  ``lm_loss`` on 2 eval sequences
agrees with the JAX package's within rel 1e-3 in bf16 and in NF4 (each
package quantizing its own loaded tree, to the same bytes).  The port's bf16
perplexity on the first 16 sequences is within 2% of the one recorded when
the fixture was trained (``eval_ppl_bf16_n16``), the JAX quality test's own
sanity bound.  The six-format perplexity gate on all 64 sequences runs on the
card (``chip_smoke.py``, phase 4i)."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load_file

from bitsandbytes_tpu.models import llama as JL
from bitsandbytes_tpu.utils.serialization import load_checkpoint_safetensors as j_load
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.utils.serialization import load_checkpoint_safetensors as t_load
from bitsandbytes_tpu_torch.utils.serialization import read_safetensors
from test_torch_serialization import _assert_tree_equal, _same

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CKPT = os.path.join(FIXDIR, "quality_lm.safetensors")


@pytest.fixture(scope="module")
def loaded():
    with open(os.path.join(FIXDIR, "quality_lm.json")) as f:
        meta = json.load(f)
    c = meta["config"]
    jcfg = JL.LlamaConfig(**c, dtype=jnp.bfloat16)
    tcfg = TL.LlamaConfig(**c, dtype=torch.bfloat16)
    jp = j_load(CKPT, JL.init_params(jax.random.PRNGKey(0), jcfg))
    tp = t_load(CKPT, TL.init_params(tcfg, device="cpu"), device="cpu")
    ids = np.load(os.path.join(FIXDIR, "quality_eval_ids.npy"))
    return jcfg, tcfg, jp, tp, ids, meta


def test_both_packages_load_the_same_tree(loaded):
    _, _, jp, tp, _, _ = loaded
    _assert_tree_equal(tp, jp)
    assert tp["embed"].dtype == torch.bfloat16 and len(tp["layers"]) == 4


def test_reader_matches_safetensors_package():
    ours, metadata = read_safetensors(CKPT)
    ref = st_load_file(CKPT)
    assert set(ours) == set(ref) and len(ours) == 39
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype == torch.bfloat16
        _same(ours[k], v, k)


@pytest.mark.parametrize("fmt", ["bf16", "nf4"])
def test_lm_loss_matches_jax_on_two_eval_sequences(loaded, fmt):
    jcfg, tcfg, jp, tp, ids, _ = loaded
    if fmt == "nf4":
        jp, tp = JL.quantize_params_4bit(jp), TL.quantize_params_4bit(tp)
    jl = float(JL.lm_loss(jp, None, jnp.asarray(ids[:2]), jcfg))
    with torch.no_grad():
        tl = float(TL.lm_loss(tp, None, torch.from_numpy(ids[:2]).long(), tcfg))
    assert abs(tl - jl) / jl < 1e-3, (tl, jl)


def test_port_bf16_perplexity_reproduces_training_eval(loaded):
    _, tcfg, _, tp, ids, meta = loaded
    with torch.no_grad():
        ppl = math.exp(float(TL.lm_loss(tp, None, torch.from_numpy(ids[:16]).long(), tcfg)))
    ref = meta["eval_ppl_bf16_n16"]
    assert abs(ppl - ref) / ref < 0.02, (ppl, ref)
