"""The port's 8-bit optimizer update (kernels 14 and 15's plain version) on
bf16 and f16 parameters, against the JAX package on the CPU.

Both packages compute the step in f32 and store the parameter in its own
type, rounded to nearest even.  On bf16 ``[2148]`` leaves (numpy seed 5,
a partial last block), steps 1, 3 and 5: against the JAX package's fused
Pallas kernel in interpret mode every output is bit-identical (parameter,
state codes, absmax), and so is AdEMAMix on f16.  AdamW on f16 keeps
``tests/test_torch_optim8bit.py``'s f32 contract with that kernel (the f32
parameter within 3e-7): f16's finer rounding lets one element in 2148 land
1 ulp apart, its codes and absmax still equal.  Against its public
``optimizer_update_8bit_blockwise`` (the jitted segment tier) the parameter
is bit-identical and the codes and absmax equal, but for AdamW's second-
moment absmax, which that tier may put 1 ulp off its own Pallas kernel
(XLA contracts ``(1 - beta2) * g * g + beta2 * v`` into a fused
multiply-add there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.functional import blockwise as JB
from bitsandbytes_tpu.functional import optim_update as JU
from bitsandbytes_tpu.functional.codebooks import create_dynamic_map
from bitsandbytes_tpu.ops.pallas.optim8bit import optimizer_update_8bit_pallas
from bitsandbytes_tpu_torch.functional import optim_update as TU

torch.set_num_threads(1)

Q1 = np.asarray(create_dynamic_map(signed=True), np.float32)
Q2 = np.asarray(create_dynamic_map(signed=False), np.float32)
N_EL = 2148
HYPER = {
    "adam": dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-2, lr=1e-3),  # AdamW
    "ademamix": dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-2, lr=1e-3, beta3=0.9999, alpha=5.0),
}
JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _inputs(name, dtype):
    rng = np.random.default_rng(5)
    g = (rng.standard_normal(N_EL) * 0.01).astype(np.float32)
    p = rng.standard_normal(N_EL).astype(np.float32)
    if name == "ademamix":
        m = (rng.standard_normal((2, N_EL)) * 0.01).astype(np.float32)
        q = [[np.array(a) for a in JB.quantize_blockwise_with_code(jnp.asarray(x), jnp.asarray(Q1), 256)] for x in m]
        s1, am1 = np.stack([q[0][0], q[1][0]]), np.stack([q[0][1], q[1][1]])
    else:
        m = (rng.standard_normal(N_EL) * 0.01).astype(np.float32)
        s1, am1 = (np.array(a) for a in JB.quantize_blockwise_with_code(jnp.asarray(m), jnp.asarray(Q1), 256))
    v = (np.abs(rng.standard_normal(N_EL)) * 1e-4).astype(np.float32)
    s2, am2 = (np.array(a) for a in JB.quantize_blockwise_with_code(jnp.asarray(v), jnp.asarray(Q2), 256))
    gj, pj = jnp.asarray(g, JDT[dtype]), jnp.asarray(p, JDT[dtype])
    # the same rounded values on both sides
    gt = torch.from_numpy(np.asarray(gj.astype(jnp.float32))).to(dtype)
    pt = torch.from_numpy(np.asarray(pj.astype(jnp.float32))).to(dtype)
    return (gj, pj), (gt, pt), (s1, s2, am1, am2)


def _port(name, step, gt, pt, states):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    s1, s2, am1, am2 = states
    return TU.optimizer_update_8bit_blockwise(name, gt, pt, t(s1), t(s2), Q1, Q2, t(am1), t(am2), step=step,
                                              **HYPER[name])


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.asarray(a).view(np.uint8).reshape(-1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("step", [1, 3, 5])
@pytest.mark.parametrize("name", ["adam", "ademamix"], ids=["adamw", "ademamix"])
def test_low_precision_params_match_pallas_interpret(name, step, dtype):
    (gj, pj), (gt, pt), states = _inputs(name, dtype)
    s1, s2, am1, am2 = states
    port = _port(name, step, gt, pt, states)
    assert port[0].dtype == dtype
    ref = optimizer_update_8bit_pallas(name, gj, pj, jnp.asarray(s1), jnp.asarray(s2), Q1, Q2, jnp.asarray(am1),
                                       jnp.asarray(am2), step=step, **HYPER[name])
    assert ref[0].dtype == JDT[dtype]
    if name == "adam" and dtype == torch.float16:
        ulps = np.abs(port[0].view(torch.int16).numpy().astype(np.int64)
                      - np.asarray(ref[0]).view(np.int16).astype(np.int64))
        assert ulps.max() <= 1 and (ulps > 0).sum() <= 1, ulps.max()
    else:
        np.testing.assert_array_equal(_bits(port[0]), _bits(ref[0]), err_msg="param")
    for what, a, b in zip(("state1", "state2", "absmax1", "absmax2"), port[1:], ref[1:]):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


@pytest.mark.parametrize("step", [1, 3, 5])
@pytest.mark.parametrize("name", ["adam", "ademamix"], ids=["adamw", "ademamix"])
def test_bf16_params_match_optimizer_update_8bit_blockwise(name, step):
    (gj, pj), (gt, pt), states = _inputs(name, torch.bfloat16)
    s1, s2, am1, am2 = states
    port = _port(name, step, gt, pt, states)
    ref = JU.optimizer_update_8bit_blockwise(name, gj, pj, jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(Q1),
                                             jnp.asarray(Q2), jnp.asarray(am1), jnp.asarray(am2), step=step,
                                             **HYPER[name])
    assert ref[0].dtype == jnp.bfloat16 and port[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(port[0]), _bits(ref[0]), err_msg="param")
    for what, a, b in zip(("state1", "state2", "absmax1"), port[1:4], ref[1:4]):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)
    a2 = port[4].numpy().reshape(-1).view(np.int32).astype(np.int64)
    b2 = np.asarray(ref[4]).reshape(-1).view(np.int32).astype(np.int64)
    if name == "ademamix":
        np.testing.assert_array_equal(a2, b2, err_msg="absmax2")
    else:
        assert np.abs(a2 - b2).max() <= 1, "absmax2 more than 1 ulp from the JAX default tier"
