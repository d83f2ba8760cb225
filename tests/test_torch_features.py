"""The port's top-level ``features`` set against the JAX package's."""

import bitsandbytes_tpu
import bitsandbytes_tpu_torch


def test_features_name_the_cuda_backend():
    """The set that integrations check: ``multi_backend`` as in the JAX
    package, and the port's backend, ``cuda``, in the place of ``tpu``."""
    assert bitsandbytes_tpu_torch.features == {"multi_backend", "cuda"}
    assert bitsandbytes_tpu_torch.features - {"cuda"} == bitsandbytes_tpu.features - {"tpu"}
