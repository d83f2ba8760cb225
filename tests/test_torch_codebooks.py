"""The port's codebooks against the JAX package's: bit-identical arrays."""

import numpy as np
import pytest
import torch

from bitsandbytes_tpu.functional import codebooks as jcb
from bitsandbytes_tpu.functional.fourbit import _quantize_tables as j_quantize_tables
from bitsandbytes_tpu.ops.pallas.gemm4bit_paired import _pair_words
from bitsandbytes_tpu_torch.functional import codebooks as tcb
from bitsandbytes_tpu_torch.ops.gemm4bit_paired import _code_tuple, _units

torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("quant_type", ["nf4", "fp4", "int4", "af4"])
def test_4bit_codes_bit_identical(quant_type):
    np.testing.assert_array_equal(
        _bits(tcb.get_4bit_code(quant_type, 64)), _bits(jcb.get_4bit_code(quant_type, 64))
    )


def test_dynamic_map_bit_identical():
    np.testing.assert_array_equal(_bits(tcb.create_dynamic_map()), _bits(jcb.create_dynamic_map()))
    np.testing.assert_array_equal(
        _bits(tcb.create_dynamic_map(signed=False)), _bits(jcb.create_dynamic_map(signed=False))
    )


@pytest.mark.parametrize("quant_type", ["nf4", "fp4", "int4", "af4"])
def test_quantize_tables_match(quant_type):
    mid_j, order_j = j_quantize_tables(quant_type, 64)
    mid_t, order_t, identity = tcb.quantize_tables(quant_type, 64)
    np.testing.assert_array_equal(_bits(mid_t), _bits(np.asarray(mid_j)))
    np.testing.assert_array_equal(order_t, np.asarray(order_j))
    assert identity == (quant_type == "nf4")


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_unit_values_are_the_bf16_patterns_of_the_paired_kernel(quant_type):
    """The CUDA kernels' 16 unit values are the bf16 patterns the TPU kernel
    packs into its pair words."""
    code = tcb.get_4bit_code(quant_type, 64)
    units = np.asarray(_units(_code_tuple(code)), np.float32)
    words = np.asarray(_pair_words(tuple(float(x) for x in code)), np.int64) & 0xFFFFFFFF
    patterns = np.empty(16, np.uint32)
    patterns[0::2] = words & 0xFFFF
    patterns[1::2] = words >> 16
    np.testing.assert_array_equal(units.view(np.uint32) >> 16, patterns)
    np.testing.assert_array_equal(units.view(np.uint32) & 0xFFFF, 0)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("total_bits,add_zero", [(8, True), (8, False), (4, True), (3, False)])
def test_linear_map_bit_identical(signed, total_bits, add_zero):
    out = tcb.create_linear_map(signed=signed, total_bits=total_bits, add_zero=add_zero)
    assert out.shape == (256,) and out.dtype == np.float32
    np.testing.assert_array_equal(_bits(out), _bits(jcb.create_linear_map(signed, total_bits, add_zero)))


@pytest.mark.parametrize("offset", [0.9677083, 0.99])
@pytest.mark.parametrize("use_extra_value", [True, False])
def test_normal_map_bit_identical(offset, use_extra_value):
    out = tcb.create_normal_map(offset=offset, use_extra_value=use_extra_value)
    assert out.shape == (256,) and out.dtype == np.float32
    np.testing.assert_array_equal(_bits(out), _bits(jcb.create_normal_map(offset, use_extra_value)))


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("e,p", [(2, 1), (3, 0), (4, 3), (5, 2)])
def test_fp8_map_bit_identical(e, p, signed):
    total = e + p + (1 if signed else 0)
    out = tcb.create_fp8_map(signed, e, p, total)
    assert out.shape == (256,) and out.dtype == np.float32
    np.testing.assert_array_equal(_bits(out), _bits(jcb.create_fp8_map(signed, e, p, total)))


def test_linspace_f32_is_torch_linspace():
    for num in (2, 9, 17, 129):
        np.testing.assert_array_equal(_bits(tcb._linspace_f32(0.1, 1, num)), _bits(jcb._linspace_f32(0.1, 1, num)))
