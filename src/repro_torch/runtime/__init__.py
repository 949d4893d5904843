"""Runtime: continuous-batching scheduling."""

from .scheduler import (Request, RequestRecord, SamplingParams, Scheduler,
                        Slot, sample_token)

__all__ = ["Request", "RequestRecord", "SamplingParams", "Scheduler", "Slot",
           "sample_token"]
