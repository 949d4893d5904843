"""Block-table allocator: fixed-size KV pages with per-request chains.

The host-side half of the paged KV cache (the device-side half is
:mod:`repro_torch.runtime.kvcache.layout`), a copy of the reference's
``repro.runtime.kvcache.allocator``: importing that module loads JAX
through the reference package, so the port keeps its own.  The pool is
``n_pages`` physical pages of ``page_size`` token rows each; a request
holds a *chain* — an ordered list of page ids — and logical slot
position ``p`` lives in chain page ``p // page_size`` at row
``p % page_size``.

Two admission policies sit on top of this allocator (the scheduler
chooses; see ``runtime/scheduler.py``):

* **reserve-on-admit** (the scheduling oracle): the chain covers the
  worst-case length ``prompt + max_new_tokens`` in full at admission,
  so decode can never run dry mid-request.
* **grow-on-demand** (the default serving policy): the chain covers
  only ``pages_needed(len(prompt))`` at admission and
  :meth:`BlockAllocator.extend` appends decode pages lazily at page
  boundaries; pool exhaustion is handled by preemption
  (recompute-on-resume) in the serve loop, not by head-of-line
  over-reservation.

Design points:

* **Page 0 is the null page** and is never allocated.  Retired slots'
  page-table rows point at it, so a stale decode write from an inactive
  batch row lands in memory nobody reads instead of a page that may
  already belong to a new request.
* **Free list is LIFO** (recently freed pages are re-issued first) —
  keeps the hot working set small and makes use-after-free bugs loud in
  tests.
* **Pages are ref-counted** so chains can *share* physical pages:
  :meth:`allocate` takes a ``shared=`` prefix of already-live pages
  (prompt-prefix sharing, matched through the prefix index below),
  :meth:`fork` clones a whole chain by reference, and
  :meth:`cow_page` breaks sharing copy-on-write style — the caller
  copies the device rows, the allocator swaps in a private page.  A
  page returns to the free list only when its last holder releases it.
* **Copy-free reclamation**: ``release`` decrements refcounts and
  returns only orphaned pages to the free list.  No page is zeroed or
  copied: the next owner's attention mask only ever covers positions
  its own prefill/decode already wrote (``col <= pos``), so stale rows
  from the previous owner are unreachable by construction (the parity
  tests pin this down).
* **Prefix index**: content-hash keys (:func:`prefix_keys`) map a
  prompt's pages to live physical pages so a later request with the
  same prefix shares them instead of recomputing prefill.  Entries are
  registered by the engine once the rows are actually written and are
  dropped the moment the page is freed, so a match can never point at
  reclaimed or unwritten memory.

Pure Python, so allocation policy is unit/property-testable without a
model.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["NULL_PAGE", "BlockAllocator", "prefix_keys"]

#: Physical page id reserved as the write sink for inactive slots and
#: padded chunk rows; never handed out by the allocator, never read by
#: any active slot's gather (its page-table entries are all real pages
#: up to the chain length, and positions past the chain are masked).
NULL_PAGE = 0


def prefix_keys(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Content keys for the pages a prompt occupies, aligned with the
    chain: key ``i`` identifies the *content* of chain page ``i``.

    A KV row at position ``p`` is a pure (causal) function of tokens
    ``[0, p]``, so a *full* page ``i`` is keyed by the token prefix
    through its last row, ``tokens[:(i + 1) * page_size]``.  The
    trailing *partial* page (when ``len(tokens) % page_size != 0``) is
    keyed by the exact ``(length, tokens)`` pair — only an identical
    prompt may share it, and the sharer must copy-on-write before its
    own writes land there.  Returns ``pages_needed(len(tokens))`` keys.

    Keys are 128-bit truncations of a SHA-256 over the little-endian
    int64 token bytes (one running hash, extended page by page, so the
    whole prompt is digested once).  The builtin ``hash()`` would NOT
    do: a 64-bit collision between two distinct prompts makes a later
    request silently adopt the wrong live KV pages and emit wrong
    tokens — undetectable by :meth:`BlockAllocator.check` — so the
    content key must be collision-resistant by construction.
    """
    toks = [int(t) for t in tokens]
    n = len(toks)
    keys: List[bytes] = []
    run = hashlib.sha256()
    for i in range(n // page_size):
        for t in toks[i * page_size:(i + 1) * page_size]:
            run.update(t.to_bytes(8, "little", signed=True))
        keys.append(b"p" + run.digest()[:16])
    if n % page_size:
        tail = run.copy()
        tail.update(b"tail:%d:" % n)
        for t in toks[(n // page_size) * page_size:]:
            tail.update(t.to_bytes(8, "little", signed=True))
        keys.append(b"t" + tail.digest()[:16])
    return keys


class BlockAllocator:
    """Ref-counted free-list allocator over a fixed pool of KV pages."""

    def __init__(self, n_pages: int, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page {NULL_PAGE} is the reserved "
                f"null page), got {n_pages}")
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO free list over pages [1, n_pages); page 0 stays reserved.
        self._free: List[int] = list(range(n_pages - 1, NULL_PAGE, -1))
        self._chains: Dict[int, List[int]] = {}
        self._ref: Dict[int, int] = {}         # live page -> holder count
        self._prefix: Dict[bytes, int] = {}    # content key -> live page
        self._page_key: Dict[int, bytes] = {}  # live page -> content key

    # -- accounting -----------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable pages (the null page is not allocatable)."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.capacity - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_pages / self.capacity

    def pages_needed(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` rows.  Zero tokens need zero
        pages — an empty chain is legal under grow-on-demand (the chain
        grows before the first write); the old ``max(1, ...)`` made
        every empty-prompt admit burn a page for nothing."""
        if n_tokens <= 0:
            return 0
        return -(-n_tokens // self.page_size)

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def chain(self, uid: int) -> List[int]:
        """The live chain of ``uid`` (copy), for page-table assembly."""
        return list(self._chains[uid])

    def chain_len(self, uid: int) -> int:
        return len(self._chains[uid])

    def live_uids(self) -> List[int]:
        return sorted(self._chains)

    def page_ref(self, page: int) -> int:
        """Holder count of ``page`` (0 if free)."""
        return self._ref.get(page, 0)

    def page_shared(self, uid: int, block_idx: int) -> bool:
        """True when chain page ``block_idx`` of ``uid`` is held by more
        than one chain — a write there must :meth:`cow_page` first."""
        return self._ref[self._chains[uid][block_idx]] > 1

    # -- alloc / free -----------------------------------------------------
    def allocate(self, uid: int, n: int,
                 shared: Sequence[int] = ()) -> List[int]:
        """Build a chain for ``uid``: the ``shared`` pages by reference
        (refcount bumped; they stay owned by their other holders) plus
        ``n`` fresh pages from the free list.  ``n == 0`` with no shared
        pages yields a legal empty chain (grow-on-demand admits an
        empty prompt without burning a page).  Raises on double
        allocation or insufficient free pages (callers gate admission
        with :meth:`can_allocate`)."""
        if uid in self._chains:
            raise ValueError(f"request {uid} already holds a chain")
        if n < 0:
            raise ValueError(f"fresh page count must be >= 0, got {n}")
        for p in shared:
            if self._ref.get(p, 0) < 1:
                raise ValueError(f"shared page {p} is not live")
        if n > len(self._free):
            raise MemoryError(
                f"request {uid} needs {n} pages, only "
                f"{len(self._free)} free")
        chain = []
        for p in shared:
            self._ref[p] += 1
            chain.append(p)
        for _ in range(n):
            p = self._free.pop()
            self._ref[p] = 1
            chain.append(p)
        self._chains[uid] = chain
        return list(chain)

    def extend(self, uid: int, n_more: int) -> List[int]:
        """Append ``n_more`` fresh pages to ``uid``'s chain — the
        grow-on-demand decode path, called at page boundaries.  On
        exhaustion raises ``MemoryError`` with the chain untouched (the
        caller preempts a victim and retries)."""
        if uid not in self._chains:
            raise KeyError(f"request {uid} holds no chain")
        if n_more < 0:
            raise ValueError(f"n_more must be >= 0, got {n_more}")
        if n_more > len(self._free):
            raise MemoryError(
                f"request {uid} needs {n_more} more pages, only "
                f"{len(self._free)} free")
        new = []
        for _ in range(n_more):
            p = self._free.pop()
            self._ref[p] = 1
            new.append(p)
        self._chains[uid].extend(new)
        return list(new)

    def fork(self, parent_uid: int, child_uid: int) -> List[int]:
        """Clone ``parent_uid``'s whole chain by reference for
        ``child_uid`` (every page's refcount bumped; no rows copied).
        Writers on either side must :meth:`cow_page` before touching a
        shared page."""
        if parent_uid not in self._chains:
            raise KeyError(f"request {parent_uid} holds no chain")
        if child_uid in self._chains:
            raise ValueError(f"request {child_uid} already holds a chain")
        chain = list(self._chains[parent_uid])
        for p in chain:
            self._ref[p] += 1
        self._chains[child_uid] = chain
        return list(chain)

    def cow_page(self, uid: int, block_idx: int) -> Optional[Tuple[int, int]]:
        """Break sharing of chain page ``block_idx`` before a write:
        if the page is uniquely held, returns ``None`` (write in
        place); otherwise swaps a fresh private page into the chain and
        returns ``(old_page, new_page)`` — the CALLER must copy the
        device rows old -> new before writing.  The old page stays live
        with its remaining holders (and its prefix-index entry)."""
        chain = self._chains[uid]
        old = chain[block_idx]
        if self._ref[old] == 1:
            return None
        if not self._free:
            raise MemoryError(
                f"request {uid} needs a private copy of page {old}, "
                "no pages free")
        new = self._free.pop()
        self._ref[new] = 1
        self._ref[old] -= 1
        chain[block_idx] = new
        return old, new

    def release(self, uid: int) -> List[int]:
        """Drop ``uid``'s chain: every page's refcount is decremented
        and orphaned pages return to the free list untouched (copy-free
        — stale rows are unreachable through any other chain's mask).
        Returns the pages actually reclaimed (shared pages survive with
        their other holders)."""
        chain = self._chains.pop(uid, None)
        if chain is None:
            raise KeyError(f"request {uid} holds no chain")
        freed = []
        for p in chain:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._drop_prefix_entry(p)
                self._free.append(p)
                freed.append(p)
        return freed

    # -- prefix sharing ----------------------------------------------------
    def _drop_prefix_entry(self, page: int) -> None:
        key = self._page_key.pop(page, None)
        if key is not None:
            del self._prefix[key]

    def register_prefix(self, key: bytes, page: int) -> bool:
        """Publish ``page`` as the holder of content ``key`` so later
        admissions can share it.  First writer wins: an existing entry
        for the key (or a page already published under another key) is
        left alone.  The page must be live — callers register only
        after the rows are actually written."""
        if self._ref.get(page, 0) < 1:
            raise ValueError(f"page {page} is not live")
        if key in self._prefix or page in self._page_key:
            return False
        self._prefix[key] = page
        self._page_key[page] = key
        return True

    def register_chain_prefix(self, uid: int,
                              keys: Sequence[bytes]) -> int:
        """Register ``uid``'s chain pages under their content keys
        (:func:`prefix_keys` of the prompt, computed by the caller once
        prefill has written the rows).  Returns how many new entries
        were published."""
        chain = self._chains[uid]
        published = 0
        for i, key in enumerate(keys):
            if i >= len(chain):
                break
            published += bool(self.register_prefix(key, chain[i]))
        return published

    def match_prefix(self, keys: Sequence[bytes]) -> List[int]:
        """Longest run of live indexed pages covering ``keys`` from the
        start — the pages a new admission can adopt as its shared chain
        prefix (refcounts are bumped by :meth:`allocate`, not here)."""
        out: List[int] = []
        for key in keys:
            page = self._prefix.get(key)
            if page is None:
                break
            out.append(page)
        return out

    # -- invariant check (tests call this after every step) ---------------
    def check(self) -> None:
        """Assert structural invariants: refcount conservation (every
        live page's count equals the number of chains holding it), no
        page both live and free, full pool conservation, null page
        never issued, and prefix-index consistency (every entry points
        at a live page, maps mutually inverse)."""
        counted: Dict[int, int] = {}
        for uid, chain in self._chains.items():
            assert len(set(chain)) == len(chain), \
                f"chain {uid} holds a page twice"
            for p in chain:
                assert p != NULL_PAGE, "null page was allocated"
                counted[p] = counted.get(p, 0) + 1
        assert counted == self._ref, \
            f"refcount drift: counted {counted} != tracked {self._ref}"
        live = set(counted)
        free = set(self._free)
        assert NULL_PAGE not in free, "null page on the free list"
        assert len(free) == len(self._free), "page twice on the free list"
        assert not (live & free), "page both live and free"
        assert len(live) + len(free) == self.capacity, \
            "pages leaked or invented"
        assert self._prefix == {k: p for p, k in self._page_key.items()}, \
            "prefix index maps out of sync"
        for page in self._page_key:
            assert page in self._ref, f"indexed page {page} is not live"
