"""PagedKV layout: the device-side half of the paged KV cache.

A contiguous decode cache stores leaf ``(B, max_seq, ...)``; the paged
pool stores the same rows as ``(n_pages, page_size, ...)`` with a
per-slot *page table* ``pages: (B, blocks_per_slot)`` mapping logical
slot position ``p`` to physical row
``pool[pages[b, p // page_size], p % page_size]``.

Four primitives thread this layout through the model, as torch indexing
on the pool's device (the reference computes them with ``jnp.take`` and
``.at[].set`` outside any kernel):

* :func:`paged_view` — gather a slot-contiguous ``(B, view_len, ...)``
  read view of every slot's chain (one ``index_select`` per leaf;
  attention runs on the view exactly as it would on a contiguous cache,
  with the same ``col <= pos`` validity mask in slot-logical
  coordinates).
* :func:`paged_write_rows` — scatter one decode row per slot at its own
  position (the continuous-batching write).  Inactive slots' page-table
  rows are all :data:`NULL_PAGE`, so their stale writes land in the
  null page.
* :func:`paged_write_chunk` — scatter a prefill chunk's rows
  (``C`` consecutive positions of ONE slot); rows past ``chunk_len``
  (bucket padding) are redirected to the null page so they can never
  clobber a neighbouring chain.
* :func:`copy_page` — copy one physical page's rows to another (the
  device half of copy-on-write: the allocator swaps a private page
  into the chain, this moves the shared page's rows over before the
  owner's next write lands).

The reference is functional; here every write goes into the pool in
place, as the contiguous cache's row write does, so a copy-on-write
copy must run before the owner's next write.  Several padded or
inactive rows may scatter to the same null-page row: nobody reads those
rows unmasked, so which one lands does not matter.

:class:`PagedKV` carries the static geometry (page size, pool size,
page-table width) and the host-side page-table assembly helpers the
engine uses around the model calls.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .allocator import NULL_PAGE

__all__ = ["PagedKV", "copy_page", "paged_view", "paged_write_rows",
           "paged_write_chunk", "NULL_PAGE"]


@dataclasses.dataclass(frozen=True)
class PagedKV:
    """Static geometry of one engine's paged KV cache."""

    page_size: int        #: token rows per physical page
    n_pages: int          #: physical pages in the pool (incl. null page 0)
    blocks_per_slot: int  #: page-table width = ceil(max_seq / page_size)

    @property
    def view_len(self) -> int:
        """Sequence length of the gathered per-slot read view (>= the
        engine's max_seq; attention masks the overhang)."""
        return self.blocks_per_slot * self.page_size

    @classmethod
    def build(cls, max_seq: int, n_slots: int, page_size: int = 16,
              n_pages: Optional[int] = None) -> "PagedKV":
        """Geometry for an engine: ``n_pages`` defaults to full backing
        (every slot can hold max_seq rows, plus the null page) — pass a
        smaller pool to actually decouple KV memory from
        ``max_seq * n_slots`` and let admission gate on free pages."""
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        blocks = -(-max_seq // page_size)
        if n_pages is None:
            n_pages = n_slots * blocks + 1
        if n_pages < blocks + 1:
            raise ValueError(
                f"n_pages={n_pages} cannot back even one max_seq request "
                f"({blocks} pages + the null page)")
        return cls(page_size=page_size, n_pages=n_pages,
                   blocks_per_slot=blocks)

    # -- host-side page-table assembly ------------------------------------
    def empty_tables(self, n_slots: int) -> np.ndarray:
        """(n_slots, blocks_per_slot) page tables, all null."""
        return np.full((n_slots, self.blocks_per_slot), NULL_PAGE,
                       np.int32)

    def set_chain(self, tables: np.ndarray, slot: int,
                  chain: Sequence[int]) -> None:
        """Install a request's chain in ``tables[slot]`` (rest null)."""
        if len(chain) > self.blocks_per_slot:
            raise ValueError(
                f"chain of {len(chain)} pages exceeds the page-table "
                f"width {self.blocks_per_slot}")
        tables[slot, :] = NULL_PAGE
        tables[slot, :len(chain)] = np.asarray(chain, np.int32)

    def clear_chain(self, tables: np.ndarray, slot: int) -> None:
        """Point a retired slot's page table back at the null page."""
        tables[slot, :] = NULL_PAGE

    def chunk_spans(self, n_tokens: int, chunk: int) -> List[tuple]:
        """Split a prompt into page-aligned prefill chunks:
        ``[(start, length), ...]`` with every start a multiple of
        ``chunk`` (itself a multiple of page_size) and lengths summing
        to ``n_tokens``."""
        if chunk < 1 or chunk % self.page_size:
            raise ValueError(
                f"prefill chunk {chunk} must be a positive multiple of "
                f"page_size {self.page_size}")
        return [(s, min(chunk, n_tokens - s))
                for s in range(0, n_tokens, chunk)]


# ---------------------------------------------------------------------------
# Gather/scatter on the pool's device
# ---------------------------------------------------------------------------

def paged_view(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Gather the slot-contiguous read view.

    pool:  (n_pages, page_size, ...)
    pages: (B, n_blocks) int64 page table
    ->     (B, n_blocks * page_size, ...)
    """
    b, n_blk = pages.shape
    v = pool.index_select(0, pages.reshape(-1))
    return v.reshape(b, n_blk * pool.shape[1], *pool.shape[2:])


def paged_write_rows(pool: torch.Tensor, rows: torch.Tensor,
                     pages: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Scatter one row per slot at its own logical position, in place.

    pool:  (n_pages, page_size, ...)
    rows:  (B, ...) — one new cache row per slot
    pages: (B, n_blocks) int64; pos: (B,) logical positions
    """
    p = pool.shape[1]
    pos = pos.long()
    # the reference's clip: JAX clamps a gather index, torch would raise
    blk = (pos // p).clamp(0, pages.shape[1] - 1)
    page = pages.gather(1, blk[:, None])[:, 0]
    pool[page, pos % p] = rows.to(pool.dtype)
    return pool


def paged_write_chunk(pool: torch.Tensor, rows: torch.Tensor,
                      pages_row: torch.Tensor, pos_start: int,
                      chunk_len: int) -> torch.Tensor:
    """Scatter a prefill chunk: C consecutive rows of ONE slot, in place.

    pool:      (n_pages, page_size, ...)
    rows:      (C, ...) — the chunk's new cache rows
    pages_row: (n_blocks,) int64 — the prefilling slot's page table
    pos_start: absolute position of the chunk's first row
    chunk_len: true rows; rows past it are bucket padding and are
               redirected to the null page.
    """
    p = pool.shape[1]
    j = torch.arange(rows.shape[0], device=pool.device)
    pos = int(pos_start) + j
    blk = (pos // p).clamp(0, pages_row.shape[0] - 1)
    page = torch.where(j < int(chunk_len), pages_row[blk], NULL_PAGE)
    pool[page, pos % p] = rows.to(pool.dtype)
    return pool


def copy_page(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Copy page ``src``'s rows over page ``dst`` (copy-on-write break),
    in place."""
    pool[dst].copy_(pool[src])
    return pool
