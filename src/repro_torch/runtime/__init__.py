"""Runtime: continuous-batching scheduling and the paged KV cache."""

from .kvcache import (NULL_PAGE, BlockAllocator, PagedKV, copy_page,
                      paged_view, paged_write_chunk, paged_write_rows,
                      prefix_keys)
from .scheduler import (Request, RequestRecord, SamplingParams, Scheduler,
                        Slot, sample_token)

__all__ = ["BlockAllocator", "NULL_PAGE", "PagedKV", "Request",
           "RequestRecord", "SamplingParams", "Scheduler", "Slot",
           "copy_page", "paged_view", "paged_write_chunk",
           "paged_write_rows", "prefix_keys", "sample_token"]
