"""Outlier dimensions of weights and activations.

Counterpart of the JAX package's ``utils/outliers.py`` (the reference's
``OutlierTracer`` and ``GlobalOutlierPooler``): find the feature dimensions
whose magnitudes are outliers, LLM.int8()'s emergent features
(arXiv:2208.07339), so that they can be kept in higher precision.  Plain
functions over tensors: call them where the tensors are.
"""

from __future__ import annotations

from typing import Optional, Set

import torch

__all__ = ["find_outlier_dims", "OutlierPool"]


def find_outlier_dims(
    weight: torch.Tensor,
    reduction_dim: int = 0,
    zscore: float = 4.0,
    topk: Optional[int] = None,
) -> torch.Tensor:
    """The features (the dimensions left after reducing ``reduction_dim``)
    whose float32 L2 norm is an outlier: with ``topk``, the indices of the
    ``topk`` largest norms, largest first; otherwise a boolean mask of the
    norms more than ``zscore`` population standard deviations above their
    mean (a fixed shape, as the JAX package returns it)."""
    m = torch.linalg.vector_norm(weight.to(torch.float32), dim=reduction_dim)
    if topk is not None:
        return torch.topk(m, topk).indices
    mu = m.mean()
    sd = m.std(correction=0)
    return (m - mu) / torch.clamp(sd, min=1e-12) > zscore


class OutlierPool:
    """Outlier dimensions gathered across layers (the reference's
    ``GlobalOutlierPooler``).  Only layers whose feature dimension is the
    first one seen (the model's) add to the pool."""

    def __init__(self):
        self.outliers: Set[int] = set()
        self.model_dim: Optional[int] = None

    def add_outliers(self, outlier_idx, feature_dim: int) -> None:
        if self.model_dim is None:
            self.model_dim = feature_dim
        if feature_dim != self.model_dim:
            return
        self.outliers.update(torch.as_tensor(outlier_idx).reshape(-1).tolist())

    def get_current_outlier_idx(self) -> torch.Tensor:
        return torch.tensor(sorted(self.outliers), dtype=torch.int64)
