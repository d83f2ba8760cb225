"""Serving: continuous-batching decode over quantized weights."""

from .engine import ContinuousBatchingEngine, GenerationResult

__all__ = ["ContinuousBatchingEngine", "GenerationResult"]
