"""Paged/block KV-cache subsystem for the continuous-batching engine.

Decouples KV memory from ``max_seq * n_slots``: requests are admitted
against a pool of fixed-size pages (:class:`BlockAllocator`), every
slot addresses its pages through a per-slot page table handed to the
decode step (:mod:`repro_torch.runtime.kvcache.layout`), and long
prompts prefill in page-aligned chunks interleaved with decode steps
(``Engine(kv_layout="paged")`` in :mod:`repro_torch.launch.serve`).
"""

from .allocator import NULL_PAGE, BlockAllocator, prefix_keys
from .layout import (PagedKV, copy_page, paged_view, paged_write_chunk,
                     paged_write_rows)

__all__ = ["BlockAllocator", "NULL_PAGE", "PagedKV", "copy_page",
           "paged_view", "paged_write_rows", "paged_write_chunk",
           "prefix_keys"]
