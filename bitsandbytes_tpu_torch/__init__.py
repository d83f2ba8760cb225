"""bitsandbytes_tpu_torch: the PyTorch and CUDA port of the JAX package.

The port keeps the JAX package's module tree.  Plain tensor code is
PyTorch; each TPU kernel on the ported path is a CUDA C++ kernel written for
Hopper (``csrc/``), built with ``nvcc`` at first use.  A CUDA tensor runs
the kernel, a CPU tensor the plain PyTorch version beside it.  Entry points
that create tensors run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: NF4/FP4 quantization with an optionally double-quantized
absmax (``compress_statistics``), blockwise 8-bit quantization, the
paired-layout 4-bit GEMM, its backward and the dequantize (also decoding a
double-quantized absmax in the kernel), flash attention over a bf16 KV
cache, the 8-bit blockwise optimizers (``optim``) and LLM.int8() (the int8
ops of ``functional``, :func:`matmul` with its backward, ``nn.Linear8bitLt``),
serving the Llama family through prefill and greedy decode, on 4-bit or int8
weights, fine-tuning it with QLoRA, checkpoints in the reference's
serialized names (``utils.serialization``: npz, safetensors, HF Llama import),
serving over a mesh of ranks (``parallel``: sharded weights and KV caches,
packed-payload collectives, ``forward(mesh=)`` and the engine), the MoE FFN
with expert parallelism (``models.moe``) and the host quantizer
(``utils.native``).
"""

from . import functional, nn, optim
from .autograd import MatmulLtState, matmul, matmul_4bit
from .functional import QuantState
from .functional.gemm import gemm_4bit, gemv_4bit

__version__ = "0.1.0"

__all__ = [
    "functional",
    "nn",
    "optim",
    "matmul_4bit",
    "matmul",
    "MatmulLtState",
    "gemm_4bit",
    "gemv_4bit",
    "QuantState",
    "__version__",
]
