"""Timing on the card, weight interop, checkpoints, model surgery and the
host quantizer (``native``)."""

from . import native
from .benchmark import sol_fraction
from .compat import OutlierTracer, pack_dict_to_tensor, replace_linear, unpack_tensor_to_dict
from .outliers import OutlierPool, find_outlier_dims
from .serialization import (
    import_hf_llama,
    load_checkpoint,
    load_checkpoint_safetensors,
    params_from_state_dict,
    save_checkpoint,
    save_checkpoint_safetensors,
    state_dict_from_params,
)

__all__ = [
    "native",
    "sol_fraction",
    "OutlierPool",
    "OutlierTracer",
    "find_outlier_dims",
    "state_dict_from_params",
    "params_from_state_dict",
    "save_checkpoint",
    "load_checkpoint",
    "save_checkpoint_safetensors",
    "load_checkpoint_safetensors",
    "import_hf_llama",
    "pack_dict_to_tensor",
    "unpack_tensor_to_dict",
    "replace_linear",
]
