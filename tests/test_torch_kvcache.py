"""The port's paged KV cache: the tests of tests/test_kvcache.py mirrored on
``repro_torch`` (block-allocator invariants, PagedKV geometry and layout
ops, page-gated admission, grow-on-demand preemption, paged engine ==
contiguous engine), plus cross-checks against the reference itself:

* ``prefix_keys``, the allocator and the four layout ops against
  ``repro.runtime.kvcache`` on the same inputs;
* the port's paged engine against ``repro.launch.serve.Engine(
  kv_layout="paged")`` on bridged weights (reduced smollm, float32): the
  same tokens and the same chunk, preemption, prefix-hit and
  copy-on-write counts; and grow against reserve at 12 usable pages.

The int8 and MLA cache variants' engine tests are in
tests/test_torch_kvcache_variants.py and tests/test_torch_mla.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_mesh
from repro.launch.serve import Engine as JEngine
from repro.runtime import kvcache as jkv
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.scheduler import SamplingParams as JSamplingParams
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.topk_gather import topk_gather
from repro_torch.launch.serve import Engine
from repro_torch.models import transformer as T
from repro_torch.runtime.kvcache import (NULL_PAGE, BlockAllocator, PagedKV,
                                         copy_page, paged_view,
                                         paged_write_chunk, paged_write_rows,
                                         prefix_keys)
from repro_torch.runtime.scheduler import Request, SamplingParams, Scheduler


# ---------------------------------------------------------------------------
# BlockAllocator: unit tests (pure Python)
# ---------------------------------------------------------------------------

def test_allocator_basics_and_accounting():
    a = BlockAllocator(n_pages=9, page_size=4)
    assert a.capacity == 8 and a.free_pages == 8 and a.used_pages == 0
    chain = a.allocate(0, 3)
    assert len(chain) == 3 and NULL_PAGE not in chain
    assert a.used_pages == 3 and a.occupancy == pytest.approx(3 / 8)
    assert a.chain(0) == chain
    assert a.live_uids() == [0]
    freed = a.release(0)
    assert sorted(freed) == sorted(chain)
    assert a.free_pages == 8
    a.check()
    with pytest.raises(ValueError):
        BlockAllocator(n_pages=1, page_size=4)   # only the null page
    with pytest.raises(ValueError):
        BlockAllocator(n_pages=4, page_size=0)


def test_allocator_pages_needed_rounds_up():
    a = BlockAllocator(n_pages=4, page_size=8)
    # zero tokens need zero pages: an empty prompt admitted under grow
    # must not burn a page for nothing
    assert a.pages_needed(0) == 0
    assert a.pages_needed(1) == 1
    assert a.pages_needed(8) == 1
    assert a.pages_needed(9) == 2
    assert a.pages_needed(17) == 3


def test_allocator_rejects_double_alloc_and_overflow():
    a = BlockAllocator(n_pages=4, page_size=2)  # capacity 3
    a.allocate(1, 2)
    with pytest.raises(ValueError):
        a.allocate(1, 1)             # uid already holds a chain
    assert not a.can_allocate(2)
    with pytest.raises(MemoryError):
        a.allocate(2, 2)             # only 1 page free
    with pytest.raises(ValueError):
        a.allocate(3, -1)            # negative page count
    assert a.allocate(3, 0) == []    # empty chain is legal (grow policy)
    with pytest.raises(KeyError):
        a.release(99)                # never allocated
    a.release(3)
    a.check()


def test_allocator_extend_grows_chain():
    a = BlockAllocator(n_pages=6, page_size=2)
    first = a.allocate(0, 2)
    more = a.allocate(1, 1)
    grown = a.extend(0, 2)
    assert a.chain(0) == first + grown
    assert not (set(grown) & set(first)) and not (set(grown) & set(more))
    with pytest.raises(MemoryError):
        a.extend(0, 1)               # pool exhausted
    with pytest.raises(KeyError):
        a.extend(7, 1)
    a.check()


def test_allocator_extend_exhaustion_keeps_chain_intact():
    """A failed extend raises MemoryError and leaves the chain exactly as
    it was (the engine preempts a victim and retries)."""
    a = BlockAllocator(n_pages=5, page_size=2)       # 4 usable
    chain = a.allocate(0, 3)
    a.allocate(1, 1)
    with pytest.raises(MemoryError):
        a.extend(0, 2)               # only 0 free
    assert a.chain(0) == chain       # untouched by the failed extend
    a.check()
    a.release(1)
    assert a.extend(0, 1)            # now it fits
    a.check()


def test_allocator_free_list_is_lifo():
    a = BlockAllocator(n_pages=8, page_size=2)
    a.allocate(0, 2)
    mid = a.allocate(1, 2)
    a.allocate(2, 2)
    freed = a.release(1)
    assert freed == mid
    # LIFO: the re-issue pops the most recently freed page first
    assert a.extend(0, 2) == mid[::-1]
    a.check()


def test_allocator_interleaved_extend_release_invariants():
    a = BlockAllocator(n_pages=10, page_size=2)
    a.allocate(0, 1)
    a.allocate(1, 2)
    for _ in range(3):
        a.extend(0, 1)
        a.check()
    a.release(1)
    a.check()
    a.extend(0, 2)
    a.check()
    assert a.chain_len(0) == 6
    a.release(0)
    a.check()
    assert a.free_pages == a.capacity


def test_allocator_refcounts_shared_and_fork():
    a = BlockAllocator(n_pages=8, page_size=2)
    parent = a.allocate(0, 3)
    child = a.allocate(1, 1, shared=parent[:2])      # adopt 2 pages
    assert child[:2] == parent[:2]
    assert a.page_ref(parent[0]) == 2
    assert a.page_shared(0, 0) and a.page_shared(1, 0)
    assert not a.page_shared(0, 2)
    a.check()
    # releasing the parent keeps the shared pages alive for the child
    freed = a.release(0)
    assert freed == [parent[2]]
    assert a.page_ref(parent[0]) == 1
    a.check()
    # fork clones the whole chain by reference
    forked = a.fork(1, 2)
    assert forked == a.chain(1)
    assert all(a.page_ref(p) == 2 for p in forked)
    with pytest.raises(ValueError):
        a.fork(1, 2)                 # child already holds a chain
    with pytest.raises(KeyError):
        a.fork(99, 3)
    with pytest.raises(ValueError):
        a.allocate(5, 0, shared=[parent[2]])         # freed page
    a.release(1)
    a.release(2)
    a.check()
    assert a.free_pages == a.capacity


def test_allocator_cow_page():
    a = BlockAllocator(n_pages=6, page_size=2)       # 5 usable
    chain = a.allocate(0, 2)
    a.fork(0, 1)
    # shared page: cow swaps in a fresh one, old stays with the peer
    old_new = a.cow_page(0, 0)
    assert old_new is not None
    old, new = old_new
    assert old == chain[0] and new not in chain
    assert a.chain(0)[0] == new and a.chain(1)[0] == old
    assert a.page_ref(old) == 1 and a.page_ref(new) == 1
    a.check()
    # uniquely-held page: no copy needed
    assert a.cow_page(0, 0) is None
    assert a.cow_page(0, 1) is not None    # break the remaining share
    a.check()
    # exhausted pool: cow must raise, not corrupt
    a.allocate(2, 1)                 # takes the last free page
    a.fork(2, 3)
    with pytest.raises(MemoryError):
        a.cow_page(2, 0)             # shared, but 0 pages free
    a.check()


def test_prefix_keys_page_aligned_and_tail():
    toks = list(range(10))
    keys = prefix_keys(toks, page_size=4)
    assert len(keys) == 3            # 2 full pages + tail
    # full-page keys depend only on the token prefix through the page
    assert keys[:2] == prefix_keys(toks[:8] + [99, 98], 4)[:2]
    # the tail key is exact-length/exact-content
    assert keys[2] != prefix_keys(toks + [0], 4)[2]
    assert prefix_keys(toks[:8], 4) == keys[:2]      # no tail when aligned
    assert prefix_keys([], 4) == []


def test_prefix_keys_collision_resistant_digest():
    """The keys are SHA-256 digests, not builtin hashes: ``hash(-1) ==
    hash(-2)`` in CPython, and a key collision would make a later request
    adopt the wrong live pages (wrong tokens, invisible to ``check()``)."""
    assert hash((-1,)) == hash((-2,))    # the builtin trap the digest avoids
    assert prefix_keys([-1], 4) != prefix_keys([-2], 4)
    keys = prefix_keys(list(range(10)), 4)
    assert all(isinstance(k, bytes) for k in keys)
    # full-page and tail keys live in disjoint namespaces
    assert prefix_keys([1, 2, 3, 4], 4) != prefix_keys([1, 2, 3, 4], 5)


@pytest.mark.parametrize("page_size", [1, 3, 8, 16])
def test_prefix_keys_equal_the_reference_byte_for_byte(page_size):
    rng = np.random.default_rng(page_size)
    for n in (0, 1, page_size - 1, page_size, 2 * page_size + 1, 37):
        # numpy ints, negatives and values past 32 bits, as callers pass
        toks = rng.integers(-2**40, 2**40, max(n, 0)).tolist()
        assert prefix_keys(toks, page_size) == jkv.prefix_keys(toks,
                                                               page_size)
        small = np.asarray(toks, np.int64) % 49152
        assert prefix_keys(small, page_size) == jkv.prefix_keys(small,
                                                                page_size)


def test_allocator_prefix_index_register_match_drop():
    a = BlockAllocator(n_pages=8, page_size=2)
    toks = [7, 3, 9, 1, 4]           # 2 full pages + 1 tail
    keys = prefix_keys(toks, 2)
    a.allocate(0, 3)
    assert a.register_chain_prefix(0, keys) == 3
    assert a.match_prefix(keys) == a.chain(0)
    # a prefix of the prompt matches only its full pages
    assert a.match_prefix(prefix_keys(toks[:4], 2)) == a.chain(0)[:2]
    # first registration wins; re-registering is a no-op
    assert a.register_chain_prefix(0, keys) == 0
    a.check()
    # adopting via allocate(shared=) bumps refcounts
    shared = a.match_prefix(keys)
    a.allocate(1, 0, shared=shared)
    assert all(a.page_ref(p) == 2 for p in shared)
    a.check()
    # entries die with the page: release both holders -> no matches
    a.release(0)
    assert a.match_prefix(keys) == shared            # child keeps it live
    a.release(1)
    assert a.match_prefix(keys) == []
    a.check()
    with pytest.raises(ValueError):
        a.register_prefix(keys[0], 99)               # dead page


def test_allocator_null_page_never_issued():
    a = BlockAllocator(n_pages=5, page_size=1)
    pages = []
    for uid in range(4):             # drain the whole pool
        pages += a.allocate(uid, 1)
    assert NULL_PAGE not in pages
    assert sorted(pages) == [1, 2, 3, 4]
    assert not a.can_allocate(1)
    a.check()


# ---------------------------------------------------------------------------
# BlockAllocator: alloc/free interleavings (property + seeded twin)
# ---------------------------------------------------------------------------

def _run_interleaving(n_pages, page_size, ops):
    """Drive an alloc/release script against the invariant checker and a
    shadow model of who owns what; ops = [(uid, n_tokens or None), ...]
    where None means release."""
    a = BlockAllocator(n_pages, page_size)
    owned = {}
    for uid, tok in ops:
        if tok is None:
            if uid in owned:
                freed = a.release(uid)
                assert sorted(freed) == sorted(owned.pop(uid))
        elif uid not in owned:
            n = a.pages_needed(tok)
            if a.can_allocate(n):
                owned[uid] = a.allocate(uid, n)
        a.check()                    # no double-assignment, conservation
        live = [p for c in owned.values() for p in c]
        assert len(set(live)) == len(live)
        assert a.used_pages == len(live)
    for uid in list(owned):
        a.release(uid)
        a.check()
    assert a.free_pages == a.capacity  # chains reclaim fully


@settings(max_examples=60, deadline=None)
@given(st.integers(2, 17), st.integers(1, 8),
       st.lists(st.tuples(st.integers(0, 5),
                          st.one_of(st.none(), st.integers(0, 40))),
                max_size=60))
def test_allocator_interleavings_property(n_pages, page_size, ops):
    _run_interleaving(n_pages, page_size, ops)


def test_allocator_interleavings_seeded():
    """Hypothesis-free twin of the property test."""
    rng = np.random.default_rng(0)
    for _ in range(40):
        n_pages = int(rng.integers(2, 18))
        page_size = int(rng.integers(1, 9))
        ops = [(int(rng.integers(0, 6)),
                None if rng.random() < 0.4 else int(rng.integers(0, 41)))
               for _ in range(int(rng.integers(0, 60)))]
        _run_interleaving(n_pages, page_size, ops)


def _call(alloc, name, *args):
    """(result, exception type) of one allocator call."""
    try:
        return getattr(alloc, name)(*args), None
    except (ValueError, KeyError, MemoryError) as e:
        return None, type(e)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_the_reference_op_for_op(seed):
    """The same random script of every allocator operation (allocate with
    shared pages, extend, fork, cow_page, release, register and match
    prefixes) through the port's allocator and the reference's: the same
    return values and errors, the same chains and free counts, and
    ``check()`` after each operation."""
    rng = np.random.default_rng(seed)
    ours, ref = BlockAllocator(12, 4), jkv.BlockAllocator(12, 4)
    prompts = [rng.integers(0, 50, int(rng.integers(1, 14))).tolist()
               for _ in range(4)]
    for _ in range(300):
        uid = int(rng.integers(0, 6))
        op = rng.choice(["allocate", "extend", "fork", "cow_page",
                         "release", "register", "match"])
        if op == "allocate":
            keys = prefix_keys(prompts[uid % 4], 4)
            shared = ref.match_prefix(keys)[:int(rng.integers(0, 3))]
            args = (uid, int(rng.integers(0, 4)), shared)
        elif op == "extend":
            args = (uid, int(rng.integers(0, 3)))
        elif op == "fork":
            args = (uid, int(rng.integers(0, 6)))
        elif op == "cow_page":
            if uid not in ref.live_uids() or not ref.chain_len(uid):
                continue
            args = (uid, int(rng.integers(0, ref.chain_len(uid))))
        elif op == "release":
            args = (uid,)
        elif op == "register":
            op, args = "register_chain_prefix", (
                uid, prefix_keys(prompts[uid % 4], 4))
            if uid not in ref.live_uids():
                continue
        else:
            op, args = "match_prefix", (prefix_keys(prompts[uid % 4], 4),)
        assert _call(ours, op, *args) == _call(ref, op, *args), (op, args)
        ours.check()
        assert ours.live_uids() == ref.live_uids()
        assert [ours.chain(u) for u in ours.live_uids()] == \
            [ref.chain(u) for u in ref.live_uids()]
        assert ours.free_pages == ref.free_pages


# ---------------------------------------------------------------------------
# PagedKV geometry + host-side page tables
# ---------------------------------------------------------------------------

def test_pagedkv_build_geometry():
    geo = PagedKV.build(max_seq=40, n_slots=4, page_size=16)
    assert geo.blocks_per_slot == 3          # ceil(40 / 16)
    assert geo.view_len == 48                # >= max_seq, masked overhang
    assert geo.n_pages == 4 * 3 + 1          # full backing + null page
    small = PagedKV.build(40, 4, page_size=16, n_pages=7)
    assert small.n_pages == 7
    with pytest.raises(ValueError):
        PagedKV.build(40, 4, page_size=16, n_pages=3)  # < one request
    with pytest.raises(ValueError):
        PagedKV.build(40, 4, page_size=0)
    assert dataclasses.astuple(geo) == dataclasses.astuple(
        jkv.PagedKV.build(max_seq=40, n_slots=4, page_size=16))


def test_pagedkv_tables_and_chunk_spans():
    geo = PagedKV.build(max_seq=32, n_slots=2, page_size=8)
    t = geo.empty_tables(2)
    assert t.shape == (2, 4) and (t == NULL_PAGE).all()
    geo.set_chain(t, 1, [5, 2])
    assert list(t[1]) == [5, 2, NULL_PAGE, NULL_PAGE]
    assert (t[0] == NULL_PAGE).all()
    geo.clear_chain(t, 1)
    assert (t == NULL_PAGE).all()
    with pytest.raises(ValueError):
        geo.set_chain(t, 0, [1, 2, 3, 4, 5])  # wider than the table
    assert geo.chunk_spans(20, 8) == [(0, 8), (8, 8), (16, 4)]
    assert geo.chunk_spans(8, 8) == [(0, 8)]
    with pytest.raises(ValueError):
        geo.chunk_spans(20, 12)               # not a page multiple


# ---------------------------------------------------------------------------
# layout ops: gather/scatter against a contiguous shadow and the reference
# ---------------------------------------------------------------------------

def test_paged_write_rows_and_view_roundtrip():
    P, n_pages = 4, 7
    pool = torch.zeros((n_pages, P, 3))
    # two slots, chains [1,2] and [5], slot 2 inactive (all null)
    pages = torch.tensor([[1, 2], [5, NULL_PAGE], [NULL_PAGE, NULL_PAGE]])
    rows = torch.tensor([[1., 1, 1], [2., 2, 2], [9., 9, 9]])
    out = paged_write_rows(pool, rows, pages, torch.tensor([5, 0, 3]))
    assert out is pool                       # written in place
    v = paged_view(pool, pages).numpy()
    assert v.shape == (3, 2 * P, 3)
    assert (v[0, 5] == 1.0).all()            # slot 0, pos 5 -> page 2 row 1
    assert (v[1, 0] == 2.0).all()            # slot 1, pos 0 -> page 5 row 0
    # the inactive slot's write landed in the null page, not a real one
    assert not (pool.numpy()[1:] == 9.0).any()
    assert (pool.numpy()[NULL_PAGE, 3] == 9.0).all()


def test_paged_write_chunk_pads_to_null_page():
    P = 4
    pool = torch.zeros((5, P, 2))
    chain = torch.tensor([3, NULL_PAGE, NULL_PAGE])  # 1-page chain
    rows = torch.stack([torch.full((2,), float(i + 1)) for i in range(8)])
    # 3 true rows at positions [2, 5): rows 3..7 are bucket padding and
    # must sink into the null page, NOT clobber a clamped real page
    paged_write_chunk(pool, rows, chain, 2, 3)
    got = pool.numpy()
    assert (got[3, 2] == 1.0).all() and (got[3, 3] == 2.0).all()
    real = got[1:].copy()
    real[2, 2:] = 0.0                         # the two true rows on page 3
    # position 4 (3rd true row) falls in block 1 -> null page, by design:
    # the chain is 1 page, so rows past it go to the sink too
    assert (real == 0.0).all()
    assert got[NULL_PAGE].any()               # padding mass went to the sink


def _layout_case(rng, op):
    """Random operands of one layout op as numpy arrays: a pool of 9 pages
    of 4 rows of (2, 3), 3 slots with distinct chains of up to 4 pages
    (some rows past a chain, one slot inactive), and the op's arguments.
    Duplicate scatter targets only ever hit the null page, whose rows the
    comparison skips (which duplicate lands is unspecified in both)."""
    pool = rng.standard_normal((9, 4, 2, 3)).astype(np.float32)
    ids = rng.permutation(np.arange(1, 9))
    pages = np.full((3, 4), NULL_PAGE, np.int32)
    pages[0, :3], pages[1, :2] = ids[:3], ids[3:5]
    if op == "rows":
        rows = rng.standard_normal((3, 2, 3)).astype(np.float32)
        return pool, (rows, pages, np.array([int(rng.integers(0, 12)),
                                             int(rng.integers(0, 8)),
                                             int(rng.integers(0, 16))],
                                            np.int32))
    if op == "chunk":
        rows = rng.standard_normal((8, 2, 3)).astype(np.float32)
        start = 4 * int(rng.integers(0, 3))
        return pool, (rows, pages[0], start, int(rng.integers(1, 9)))
    if op == "view":
        return pool, (pages,)
    return pool, (int(ids[0]), int(ids[1]))


PORT_OPS = {"rows": paged_write_rows, "chunk": paged_write_chunk,
            "view": paged_view, "copy": copy_page}
REF_OPS = {"rows": jkv.paged_write_rows, "chunk": jkv.paged_write_chunk,
           "view": jkv.paged_view, "copy": jkv.copy_page}


def _torch_arg(a):
    """A layout op's argument for the port: page tables and positions as
    int64 tensors (the engine sends them so), rows as they are."""
    if not isinstance(a, np.ndarray):
        return a
    t = torch.from_numpy(a)
    return t.long() if a.dtype == np.int32 else t


@pytest.mark.parametrize("op", sorted(PORT_OPS))
def test_layout_ops_match_the_reference(op):
    rng = np.random.default_rng(len(op))
    for _ in range(12):
        pool, args = _layout_case(rng, op)
        want = np.asarray(REF_OPS[op](
            jnp.asarray(pool), *(jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args)))
        got = PORT_OPS[op](torch.from_numpy(pool.copy()),
                           *map(_torch_arg, args)).numpy()
        if op in ("rows", "chunk"):
            want, got = want[1:], got[1:]     # the null page: see above
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# page-gated admission (scheduler policy)
# ---------------------------------------------------------------------------

def _req(uid, p_len, max_new=4, **kw):
    return Request(uid=uid, prompt=list(range(p_len)),
                   max_new_tokens=max_new, **kw)


def test_admission_gated_by_free_pages_not_slots():
    alloc = BlockAllocator(n_pages=5, page_size=4)     # 4 usable pages
    s = Scheduler(4, allocator=alloc)
    assert s.kv_policy == "reserve"         # the scheduler's own default
    s.submit_many([_req(0, 8, max_new=4),   # 3 pages
                   _req(1, 1, max_new=3)])  # 1 page
    admitted = s.admit()
    assert [sl.request.uid for sl in admitted] == [0, 1]
    assert alloc.free_pages == 0
    s.submit(_req(2, 1, max_new=1))
    assert s.admit() == []                  # slots free, pages aren't
    for slot in s.slots:
        if slot.busy:
            for t in range(slot.request.max_new_tokens):
                s.record_token(slot, t)
    s.retire_done()
    assert alloc.free_pages == 4            # chains reclaimed on retire
    (slot,) = s.admit()
    assert slot.request.uid == 2
    alloc.check()
    with pytest.raises(ValueError, match="kv_policy"):
        Scheduler(2, kv_policy="lazy")


def test_admission_head_of_line_blocks_fifo():
    alloc = BlockAllocator(n_pages=4, page_size=2)     # 3 usable pages
    s = Scheduler(2, allocator=alloc)
    s.submit_many([_req(0, 8, max_new=2),   # 5 pages: never fits now
                   _req(1, 1, max_new=1)])  # 1 page: would fit
    assert s.admit() == []                  # strict FIFO: head blocks tail
    assert [r.uid for r in s.queue] == [0, 1]
    alloc.check()


def test_chunked_admit_sets_prefill_state():
    s = Scheduler(1, allocator=BlockAllocator(8, 2))
    s.submit(_req(0, 5))
    (slot,) = s.admit(chunked=True)
    assert slot.prefilling and slot.prefill_pos == 0
    assert s.decoding_slots() == []
    slot.prefill_pos = 5                    # engine finished the chunks
    assert not slot.prefilling
    assert s.decoding_slots() == [slot]


# ---------------------------------------------------------------------------
# grow-on-demand admission + preemption (scheduler policy)
# ---------------------------------------------------------------------------

def test_grow_admission_uses_prompt_footprint_only():
    alloc = BlockAllocator(n_pages=5, page_size=4)   # 4 usable pages
    s = Scheduler(4, allocator=alloc, kv_policy="grow")
    # worst-case footprints are 3+3 pages (would NOT both fit under
    # reserve); prompt footprints are 2+1 and fit together under grow
    s.submit_many([_req(0, 8, max_new=4), _req(1, 1, max_new=8)])
    admitted = s.admit(chunked=True)
    assert [sl.request.uid for sl in admitted] == [0, 1]
    assert alloc.chain_len(0) == 2 and alloc.chain_len(1) == 1
    assert alloc.free_pages == 1
    alloc.check()


def test_preemption_victim_is_youngest_admitted():
    alloc = BlockAllocator(n_pages=9, page_size=4)
    s = Scheduler(3, allocator=alloc, kv_policy="grow")
    s.submit_many([_req(0, 4), _req(1, 4), _req(2, 4)])
    s.admit(chunked=True)
    victim = s.preemption_victim()
    assert victim.request.uid == 2          # last admitted, least service
    assert s.preemption_victim(exclude=(victim.index,)).request.uid == 1
    with pytest.raises(ValueError, match="not busy"):
        s.preempt(dataclasses.replace(victim, request=None))


def test_preempt_requeues_at_head_with_generated_suffix():
    alloc = BlockAllocator(n_pages=9, page_size=4)
    s = Scheduler(2, allocator=alloc, kv_policy="grow")
    s.submit_many([_req(0, 4, max_new=6), _req(1, 3, max_new=2),
                   _req(2, 2, max_new=2)])
    s.admit(chunked=True)
    slot = s.slots[0]
    slot.prefill_pos = 4                    # prefill done
    for t in (11, 12, 13):
        s.record_token(slot, t)
    rng_state = slot.rng.bit_generator.state
    s.preempt(slot)
    # pages released, request back at the HEAD (before still-queued uid 2)
    assert not slot.busy
    assert 0 not in alloc.live_uids()
    assert [r.uid for r in s.queue] == [0, 2]
    resumed = s.queue[0]
    assert list(resumed.prompt) == list(_req(0, 4).prompt) + [11, 12, 13]
    assert resumed.max_new_tokens == 6
    assert s.records[0].status == "queued"
    assert s.records[0].preemptions == 1
    assert s.preemption_count == 1
    alloc.check()
    # re-admission restores generated tokens and the sampling rng, so
    # decode continues exactly where it left off
    (slot2,) = s.admit(chunked=True)
    assert slot2.request.uid == 0
    assert slot2.generated == [11, 12, 13]
    assert slot2.rng.bit_generator.state == rng_state
    assert slot2.pos == 7                   # len(prompt + generated)
    # done-accounting still counts against the ORIGINAL budget
    for t in (14, 15, 16):
        s.record_token(slot2, t)
    assert slot2.done
    s.retire_done()
    assert s.finished[0] == [11, 12, 13, 14, 15, 16]
    assert s.records[0].to_event()["preemptions"] == 1
    alloc.check()


def test_preempt_twice_rebuilds_from_original_prompt():
    """Preempting an already-resumed request rebuilds ``original_prompt +
    ALL generated``: the resumed request's .prompt already embeds the
    first round of generated tokens, and appending ``slot.generated`` to
    it again would duplicate that round."""
    alloc = BlockAllocator(n_pages=17, page_size=4)
    s = Scheduler(1, allocator=alloc, kv_policy="grow")
    orig = _req(0, 4, max_new=8)
    s.submit(orig)
    s.admit(chunked=True)
    slot = s.slots[0]
    slot.prefill_pos = 4
    for t in (11, 12):
        s.record_token(slot, t)
    s.preempt(slot)
    assert list(s.queue[0].prompt) == list(orig.prompt) + [11, 12]
    # resume, generate two more, preempt AGAIN: the rebuilt prompt must
    # hold each generated token exactly once
    (slot,) = s.admit(chunked=True)
    slot.prefill_pos = len(slot.request.prompt)
    for t in (13, 14):
        s.record_token(slot, t)
    s.preempt(slot)
    resumed = s.queue[0]
    assert list(resumed.prompt) == list(orig.prompt) + [11, 12, 13, 14]
    assert s.records[0].preemptions == 2
    alloc.check()
    # third leg runs to completion against the ORIGINAL budget
    (slot,) = s.admit(chunked=True)
    assert slot.generated == [11, 12, 13, 14]
    for t in (15, 16, 17, 18):
        s.record_token(slot, t)
    assert slot.done
    s.retire_done()
    assert s.finished[0] == [11, 12, 13, 14, 15, 16, 17, 18]
    alloc.check()


def test_grow_admission_adopts_registered_prefix_pages():
    alloc = BlockAllocator(n_pages=9, page_size=2)
    s = Scheduler(2, allocator=alloc, kv_policy="grow")
    parent = _req(0, 6, max_new=2)
    s.submit(parent)
    s.admit(chunked=True)
    # engine finished the parent's prefill and published its pages
    alloc.register_chain_prefix(0, prefix_keys(parent.prompt, 2))
    dup = _req(1, 6, max_new=2)             # same prompt (same _req range)
    s.submit(dup)
    (slot,) = s.admit(chunked=True)
    assert slot.request.uid == 1
    assert alloc.chain(1) == alloc.chain(0)  # all 3 pages adopted
    assert s.prefix_hit_pages == 3
    # prefill restarts at the last prompt token, never a full skip: the
    # final logits row must come from a real chunk forward (and its
    # shared-page write is what triggers copy-on-write in the engine)
    assert slot.prefill_pos == 5
    alloc.check()


def test_paranoid_mode_checks_the_pool_on_every_page_change(monkeypatch):
    """``REPRO_KV_CHECK=1``: admission, preemption and retirement each run
    the allocator's ``check()``, so a corrupted pool fails at once."""
    alloc = BlockAllocator(n_pages=9, page_size=4)
    calls = []
    monkeypatch.setattr(alloc, "check", lambda: calls.append(1))
    monkeypatch.setenv("REPRO_KV_CHECK", "1")
    s = Scheduler(2, allocator=alloc, kv_policy="grow")
    s.submit_many([_req(0, 4, max_new=1), _req(1, 4, max_new=1)])
    s.admit(chunked=True)
    assert len(calls) == 1
    s.preempt(s.slots[1])
    assert len(calls) == 2
    s.record_token(s.slots[0], 3)
    s.retire_done()
    assert len(calls) == 3
    monkeypatch.delenv("REPRO_KV_CHECK")
    quiet = Scheduler(2, allocator=alloc, kv_policy="grow")
    quiet.submit(_req(2, 4))
    quiet.admit(chunked=True)
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# the model's paged entry points against its contiguous ones
# ---------------------------------------------------------------------------

def _cfg(**overrides):
    base = dict(head_pad=0, compute_dtype="float32", param_dtype="float32")
    base.update(overrides)
    return get_config("smollm-360m").reduced(**base)


def test_chunked_prefill_and_paged_decode_match_the_contiguous_model():
    """Two 19-token prompts prefilled in chunks of 8 into scattered page
    chains, then three decode steps through the page tables, against one
    fused prefill and three contiguous decode steps: the same logits."""
    cfg = _cfg()
    params = T.init_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 19)))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
             for _ in range(3)]
    page, max_seq = 4, 24
    tables = torch.tensor([[7, 2, 9, 4, 11, 1], [3, 12, 5, 8, 10, 6]])
    with torch.no_grad():
        logits_c, cache = T.prefill(params, {"tokens": prompts}, cfg, max_seq)
        want = [logits_c[:, -1]]
        for i, tok in enumerate(steps):
            row, cache = T.serve_step(params, cache, {"tokens": tok},
                                      torch.full((2,), 19 + i), cfg)
            want.append(row)
        pool = T.init_paged_cache(cfg, n_pages=13, page_size=page,
                                  device="cpu")
        got = [[], []]
        for b in range(2):
            for start in range(0, 19, 8):
                ln = min(8, 19 - start)
                buf = torch.zeros((1, 8), dtype=torch.int64)
                buf[0, :ln] = prompts[b, start:start + ln]
                out, _ = T.prefill_chunk(params, pool, {"tokens": buf},
                                         start, ln, cfg, tables[b:b + 1])
                torch.testing.assert_close(
                    out[0, :ln], logits_c[b, start:start + ln],
                    rtol=1e-5, atol=1e-5)
            got[b] = out[0, ln - 1]
        got = [torch.stack(got)]
        for i, tok in enumerate(steps):
            row, _ = T.serve_step(params, pool, {"tokens": tok},
                                  torch.full((2,), 19 + i), cfg,
                                  pages=tables)
            got.append(row)
    torch.testing.assert_close(torch.stack(got), torch.stack(want),
                               rtol=1e-5, atol=1e-5)
    # the null page took only padding rows; every leaf was zero-filled
    assert all(float(leaf.abs().sum()) > 0 for c in pool for leaf in
               c.values())


def test_copy_cache_page_copies_every_layer_in_place():
    cfg = _cfg()
    pool = T.init_paged_cache(cfg, n_pages=5, page_size=4, device="cpu")
    assert len(pool) == cfg.n_layers
    assert pool[0]["k"].shape == (5, 4, cfg.n_kv_heads, cfg.head_dim)
    assert all(float(leaf.abs().sum()) == 0 for c in pool
               for leaf in c.values())
    for i, c in enumerate(pool):
        c["k"][2] = i + 1.0
        c["v"][2] = -(i + 1.0)
    leaves = [leaf for c in pool for leaf in c.values()]
    out = T.copy_cache_page(pool, 2, 4)
    assert out is pool
    for i, c in enumerate(pool):
        assert (c["k"][4] == i + 1.0).all() and (c["v"][4] == -(i + 1.0)).all()
        assert (c["k"][2] == i + 1.0).all()
    assert [leaf for c in pool for leaf in c.values()] == leaves


def test_init_paged_cache_requires_attention_pattern():
    cfg = dataclasses.replace(_cfg(), block_pattern=("mamba2",))
    assert not T.supports_fused_prefill(cfg)
    assert T.supports_fused_prefill(_cfg())
    with pytest.raises(NotImplementedError, match="attention-only"):
        T.init_paged_cache(cfg, n_pages=4, page_size=8)


# ---------------------------------------------------------------------------
# paged engine == contiguous engine, token for token
# ---------------------------------------------------------------------------

PLENS = [5, 19, 3, 26, 9, 14, 7, 22]
GENS = [6, 7, 8, 9, 10, 6, 7, 8]


def _mixed_requests(cfg, plens, gens, make=Request, sampling=SamplingParams,
                    **sp):
    rng = np.random.default_rng(0)
    return [make(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                 max_new_tokens=g, sampling=sampling(seed=i, **sp))
            for i, (n, g) in enumerate(zip(plens, gens))]


def test_paged_engine_matches_contiguous_mixed_lengths():
    """8 requests over 4 slots, mixed prompt/gen lengths (several prompts
    span multiple prefill chunks), greedy sampling, a pool SMALLER than
    full backing: the paged engine emits the contiguous engine's tokens,
    and its decode steps reach the kernel wrapper (plain version here)."""
    cfg = _cfg()
    eng_c = Engine(cfg, max_seq=40, n_slots=4, device="cpu")
    out_c, _ = eng_c.serve(_mixed_requests(cfg, PLENS, GENS))
    eng_p = Engine(cfg, max_seq=40, n_slots=4, kv_layout="paged",
                   page_size=8, n_pages=13, prefill_chunk=8,
                   params=eng_c.params, device="cpu")
    before = topk_gather.launches
    out_p, stats = eng_p.serve(_mixed_requests(cfg, PLENS, GENS))
    assert topk_gather.launches == before      # CPU: the plain version
    assert out_p == out_c
    # prompts of 19/26/22 tokens took 3/4/3 chunks of 8 — prefill really
    # was chunked, not one monolithic call per prompt
    assert stats["prefill_chunks"] == sum(-(-n // 8) for n in PLENS)
    assert stats["pages_capacity"] == 12
    assert stats["prefill_calls"] == len(PLENS)
    assert stats["decode_s"] > 0 and len(stats["ttft_s"]) == len(PLENS)
    assert sorted(eng_p.records) == list(range(len(PLENS)))
    assert eng_p.prefill_chunk == 8
    assert Engine(cfg, max_seq=40, kv_layout="paged", params=eng_c.params,
                  device="cpu").prefill_chunk == 48   # min(4 pages, view)


def test_sampling_across_a_preemption_matches_contiguous():
    """Temperature sampling through preemption and resume: the stashed
    per-request rng continues where it stopped, so the paged grow engine
    on a pool that forces preemption draws the contiguous engine's
    tokens."""
    cfg = _cfg()
    gens = [20, 16, 12, 18, 20, 16, 12, 14]
    reqs = lambda: _mixed_requests(cfg, PLENS, gens, temperature=0.9,
                                   top_k=8)
    eng_c = Engine(cfg, max_seq=48, n_slots=4, device="cpu")
    out_c, _ = eng_c.serve(reqs())
    eng_p = Engine(cfg, max_seq=48, n_slots=4, kv_layout="paged",
                   page_size=8, n_pages=13, prefill_chunk=8,
                   params=eng_c.params, device="cpu")
    out_p, stats = eng_p.serve(reqs())
    assert stats["preemptions"] >= 1, stats
    assert out_p == out_c
    greedy, _ = eng_c.serve(_mixed_requests(cfg, PLENS, gens))
    assert greedy != out_c                  # the sampling really sampled


def test_paged_serve_rejects_oversized_request():
    cfg = _cfg()
    eng = Engine(cfg, max_seq=16, n_slots=2, kv_layout="paged", page_size=8,
                 device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.serve([_req(0, 10, max_new=10)])  # 20 rows > max_seq 16


def test_engine_rejects_bad_layout_and_policy():
    cfg = _cfg()
    with pytest.raises(ValueError, match="kv_layout"):
        Engine(cfg, max_seq=16, kv_layout="ragged", device="cpu")
    with pytest.raises(ValueError, match="kv_policy"):
        Engine(cfg, max_seq=16, kv_layout="paged", kv_policy="lazy",
               device="cpu")
    with pytest.raises(ValueError, match="multiple of page_size"):
        Engine(cfg, max_seq=16, kv_layout="paged", page_size=8,
               prefill_chunk=12, device="cpu")
    with pytest.raises(ValueError, match="cannot back"):
        Engine(cfg, max_seq=32, kv_layout="paged", page_size=8, n_pages=4,
               device="cpu")


def test_cli_runs_paged_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "smollm-360m", "--device", "cpu", "--kv-layout",
          "paged", "--n-pages", "13", "--page-size", "8", "--requests", "3",
          "--gen", "4", "--prompt-len", "9"])
    line = capsys.readouterr().out
    assert "served 3 requests on cpu" in line
    assert "paged (grow)" in line and "12 pages of 8" in line


# ---------------------------------------------------------------------------
# the port's paged engine against the JAX paged engine, on the same weights
# ---------------------------------------------------------------------------

MAX_SEQ, PAGE, N_PAGES, CHUNK = 48, 8, 13, 8
# BENCH_serve.json's serve_paged_grow_vs_reserve workload: long decode
# budgets on a 12-page pool
GROW_GENS = [20, 16, 12, 18, 20, 16, 12, 14]


def _prefix_workload(vocab):
    """Duplicated and extended prompts: a parent that stays decoding while
    three budget-1 fillers pass through the other slots, so that its exact
    duplicate is admitted after the parent's pages are published and
    adopts them (copy-on-write of the shared last page), and an extension
    adopts its full pages (prefix hits); long budgets on the 12-page pool
    force preemption."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, vocab, 12).tolist()
    fillers = [(rng.integers(0, vocab, 3).tolist(), 1) for _ in range(3)]
    return ([(base, 30)] + fillers + [
        (base, 30), (base + rng.integers(0, vocab, 9).tolist(), 20),
        (rng.integers(0, vocab, 20).tolist(), 28)])


@pytest.fixture(scope="module")
def jax_paged():
    """The JAX paged grow engine (reduced smollm, float32) and the port's
    config and bridged params; the JAX engine compiles once per module."""
    kw = dict(head_pad=0, compute_dtype="float32", param_dtype="float32")
    jcfg = jget_config("smollm-360m").reduced(**kw)
    cfg = get_config("smollm-360m").reduced(**kw)
    jeng = JEngine(jcfg, make_mesh((1, 1), ("data", "model")),
                   max_seq=MAX_SEQ, n_slots=4, kv_layout="paged",
                   page_size=PAGE, n_pages=N_PAGES, prefill_chunk=CHUNK)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg,
                             device="cpu")
    return jeng, cfg, params


def _port_paged(cfg, params, policy="grow"):
    return Engine(cfg, max_seq=MAX_SEQ, n_slots=4, params=params,
                  kv_layout="paged", page_size=PAGE, n_pages=N_PAGES,
                  prefill_chunk=CHUNK, kv_policy=policy, device="cpu")


@pytest.mark.parametrize("workload", ["mixed", "prefix"])
def test_paged_engine_matches_the_jax_paged_engine(jax_paged, workload):
    jeng, cfg, params = jax_paged
    if workload == "mixed":
        jreqs = _mixed_requests(cfg, PLENS, GENS, JRequest, JSamplingParams)
        reqs = _mixed_requests(cfg, PLENS, GENS)
    else:
        spec = _prefix_workload(cfg.vocab_size)
        jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=g)
                 for i, (p, g) in enumerate(spec)]
        reqs = [Request(uid=i, prompt=p, max_new_tokens=g)
                for i, (p, g) in enumerate(spec)]
    jout, jstats = jeng.serve(jreqs)
    out, stats = _port_paged(cfg, params).serve(reqs)
    assert sorted(out) == list(range(len(reqs)))
    assert out == {uid: [int(t) for t in toks] for uid, toks in jout.items()}
    for key in ("decode_steps", "prefill_chunks", "preemptions",
                "prefix_hit_pages", "cow_copies", "cow_in_place",
                "grown_pages", "max_concurrent", "pages_capacity"):
        assert stats[key] == jstats[key], (key, stats, jstats)
    if workload == "prefix":
        assert stats["prefix_hit_pages"] >= 1 and stats["cow_copies"] >= 1
        assert stats["preemptions"] >= 1, stats


def test_grow_admits_more_than_reserve_at_12_pages(jax_paged):
    """At an equal 12-page pool, grow admits 4 concurrent requests and
    reserve 3 (BENCH_serve.json's row), both emitting the contiguous
    engine's tokens, and grow the JAX grow engine's, with the same
    preemptions and grown pages."""
    jeng, cfg, params = jax_paged
    jout, jstats = jeng.serve(_mixed_requests(cfg, PLENS, GROW_GENS,
                                              JRequest, JSamplingParams))
    out_c, _ = Engine(cfg, max_seq=MAX_SEQ, n_slots=4, params=params,
                      device="cpu").serve(
        _mixed_requests(cfg, PLENS, GROW_GENS))
    stats = {}
    for policy in ("reserve", "grow"):
        out, stats[policy] = _port_paged(cfg, params, policy).serve(
            _mixed_requests(cfg, PLENS, GROW_GENS))
        assert out == out_c, policy
    assert stats["grow"]["pages_capacity"] == 12
    assert stats["reserve"]["max_concurrent"] == 3
    assert stats["grow"]["max_concurrent"] == 4
    assert stats["reserve"]["preemptions"] == 0
    assert out_c == {u: [int(t) for t in v] for u, v in jout.items()}
    for key in ("max_concurrent", "preemptions", "grown_pages",
                "decode_steps", "prefill_chunks"):
        assert stats["grow"][key] == jstats[key], key
