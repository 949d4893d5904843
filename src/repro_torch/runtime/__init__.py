"""Runtime: continuous-batching scheduling, the paged KV cache, the
training loop's step-time and loss monitors, and pipeline parallelism."""

from .kvcache import (NULL_PAGE, BlockAllocator, PagedKV, copy_page,
                      paged_view, paged_write_chunk, paged_write_rows,
                      prefix_keys)
from .monitor import LossGuard, StepEvent, StepMonitor
from .pipeline_parallel import bubble_fraction, pipeline_apply
from .scheduler import (Request, RequestRecord, SamplingParams, Scheduler,
                        Slot, sample_token)

__all__ = ["BlockAllocator", "LossGuard", "NULL_PAGE", "PagedKV", "Request",
           "RequestRecord", "SamplingParams", "Scheduler", "Slot",
           "StepEvent", "StepMonitor", "bubble_fraction", "pipeline_apply",
           "copy_page", "paged_view", "paged_write_chunk",
           "paged_write_rows", "prefix_keys", "sample_token"]
