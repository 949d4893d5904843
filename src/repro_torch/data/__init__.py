"""Data substrate: deterministic synthetic streams + host prefetch."""

from .pipeline import Prefetcher, canonical
from .synthetic import batch_for, embed_batch, gsc_batch, lm_batch

__all__ = ["Prefetcher", "batch_for", "canonical", "embed_batch",
           "gsc_batch", "lm_batch"]
