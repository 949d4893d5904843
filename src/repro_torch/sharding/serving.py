"""The rank's place on a mesh: what the port runs where the reference's
rules (``make_rules(mesh, "decode")`` for a serving step, ``"train"`` for
a training step) shard a step and GSPMD partitions it.

Under those rules each rank holds (the reference's specs, leaf for leaf):

* the embedding and head tables: a block of vocabulary rows (``model``);
* q, k and v: a block of output columns (``model``); o and the FFN's down
  projection: whole; the FFN's up and gate: a block of output groups
  (``model``), their route with them where its tables divide, else whole
  (a route of several tables kept whole beside a block of groups gives
  the block a ``block_route`` of its own groups' tables, made once when
  the block is cut);
* MLA's q, uk and uv: a block of columns, its o: those rows (a
  row-parallel product, summed over ``model``), dkv and kpe whole; the
  columns are the rank's heads where ``n_heads`` divides over ``model``,
  else they cut a head and the products are gathered before the heads
  split;
* MoE: the router's columns and the routed experts' weights of the
  rank's block of experts, ``block("model", n_experts)``, each expert
  whole (its groups cannot shard over ``model`` too: a mesh axis appears
  once in a spec); where ``n_experts`` does not divide, the router and
  every expert, each expert's up and gate cut into blocks of groups (and
  a packed down into blocks of output groups); the shared experts as the
  FFN;
* the contiguous cache: a block of slots (the DP axes: ``data``, and
  ``pod`` on a multi-pod mesh) and a block of rows
  (``kvseq`` -> ``model``), or of kv heads where the rows do not divide;
  the page pools: every page, and a block of kv heads (``model``) where
  they divide;
* Mamba2: a block of ``in_proj``'s columns, of the conv's channels (its
  weights and its cache) and of the heads (``A_log``, ``dt_bias``, ``D``,
  the state ``S``), ``out_proj``'s rows of those heads; mLSTM: blocks of
  ``qkv``'s and ``gates``' columns, of the heads (``skip``, ``S``) and of
  ``out_proj``'s rows; sLSTM: blocks of ``wx``'s columns, ``r``'s heads
  and ``b``, its state and ``out_proj`` whole.  Where a dimension does not
  divide over ``model`` its leaf is whole (:meth:`Rules.resolve`).

Under ``make_rules(mesh, "decode_long")`` (a batch of one) the slots are
whole and the contiguous cache's rows (MLA's latent rows too) shard over
the DP axes and ``model`` together (:meth:`Shards.rows_axes`).

A step then moves activations and never a weight: the vocab-parallel
lookup sums one non-zero term over ``model``; the q/k/v columns, the FFN
hidden (before its k-WTA, which picks from the whole row; a cut
expert's too) and head outputs are gathered over ``model``; a
sequence-sharded cache's softmax combines each rank's maximum, sum of
exponentials and weighted values over the axes its rows split over;
row-parallel partial outputs (MLA's o, the MoE's experts) are
summed with :meth:`Shards.reduce_model`; the logits are gathered over
the DP axes and ``model``.  The SSM mixers gather their projections'
column blocks, take the sum of squares of a norm over the whole width
over ``model``, and sum their row-parallel out projections; an sLSTM
rank gathers its block of the cell's pre-activations and runs the cell
on the whole state.

A training step (``make_rules(mesh, "train")``: the same blocks of the
weights, the batch's rows over the DP axes, no cache) runs the same
forward on the rank's blocks and its backward through autograd: each of
those collectives is differentiable (:mod:`repro_torch.sharding.
collectives`: a gather's backward is the rank's slice, a sum's the
identity), and :func:`enter_blocks` marks every replicated tensor that
feeds the rank's block of work (its backward sums the gradient over
``model``).  The head's logits stay vocabulary blocks and the loss is
vocab-parallel (:func:`repro_torch.models.common.cross_entropy`).

:class:`Shards` answers the model code's questions (which rows of the
batch, which block of an axis) and runs those collectives.  The engine
and the training step install it with :func:`use_serving` around their
model calls; outside, :func:`serving` is None and every model function
runs on whole tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from .axes import dp_axes, make_rules
from .collectives import enter, gather, reduce
from .context import MeshAxes, Rules, _flat

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class Shards:
    """One rank of a mesh of more than one rank, with the serving rules
    (``decode``, or ``decode_long`` for a batch of one) and the engine's
    ``max_seq`` (the contiguous cache's rows), or the training rules and
    no cache rows."""
    rules: Rules
    max_seq: int

    @classmethod
    def of(cls, mesh, max_seq: int) -> Optional["Shards"]:
        """None for a one-rank mesh (the engine then runs unsharded)."""
        if mesh is None or mesh.size == 1:
            return None
        return cls(make_rules(mesh, "decode"), max_seq)

    @property
    def mesh(self):
        return self.rules.mesh

    def size(self, axis: str) -> int:
        return self.mesh.shape.get(axis, 1)

    def block(self, axes: MeshAxes, n: int) -> Tuple[int, int]:
        """This rank's block [lo, hi) of ``n`` split evenly over ``axes``
        (an axis, or a tuple of axes, major first)."""
        idx, parts = 0, 1
        for a in _flat(axes):
            idx = idx * self.size(a) + self.mesh.coords.get(a, 0)
            parts *= self.size(a)
        k = n // parts
        return idx * k, idx * k + k

    @property
    def dp(self) -> Tuple[str, ...]:
        """The axes a batch's rows shard over (``pod`` and ``data``)."""
        return dp_axes(self.mesh)

    def vocab(self, padded_vocab: int, width: int):
        """``(start, group)`` where ``width`` (a table's rows or the
        logits' columns) is the rank's block of the vocabulary: its first
        row and the ``model`` group holding the others; None where it is
        whole."""
        if width == padded_vocab:
            return None
        return self.block("model", padded_vocab)[0], self.mesh.group("model")

    def batch_rows(self, b: int) -> Optional[slice]:
        """The rank's slots of a batch of ``b`` where the batch shards over
        the DP axes (``b`` divides), as the cache's slots do, else None
        (every rank holds them all)."""
        sharding = self.rules.sharding_for(("batch",), (b,))
        if not sharding.axes:
            return None
        return sharding.block((b,))[0]

    def _kv_spec(self, paged: bool, n_kv_heads: int) -> tuple:
        logical = (None, None, "kv", None) if paged else \
            ("batch", "kvseq", "kv", None)
        return self.rules.spec_for(logical, (1, self.max_seq, n_kv_heads, 1))

    def rows_axes(self, paged: bool, n_kv_heads: int) -> Tuple[str, ...]:
        """The mesh axes of more than one rank (major first) the cache's
        rows shard over: ``model`` under the decode rules, the DP axes and
        ``model`` under ``decode_long``; () where the rows are whole."""
        return tuple(a for a in _flat(self._kv_spec(paged, n_kv_heads)[1])
                     if self.size(a) > 1)

    def kv_split(self, paged: bool, n_kv_heads: int) -> Optional[str]:
        """What the rank's cache block holds: ``"rows"`` (a block of the
        contiguous cache's sequence, over :meth:`rows_axes`), ``"heads"``
        (kv heads, over ``model``) or None (all of it), as the cache's
        spec resolves."""
        if self.rows_axes(paged, n_kv_heads):
            return "rows"
        spec = self._kv_spec(paged, n_kv_heads)
        return "heads" if spec[2] == "model" and self.size("model") > 1 \
            else None

    # -- collectives ----------------------------------------------------------
    def reduce_model(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (or maximised) over ``model``."""
        return self.reduce(x, "model", op)

    def reduce(self, x: torch.Tensor, axes: MeshAxes, op: str = "sum"
               ) -> torch.Tensor:
        """``x`` summed (or maximised) over ``axes``: in place without
        autograd; through it a new tensor, the sum's gradient passed back
        as it is (:func:`repro_torch.sharding.collectives.reduce`)."""
        return reduce(x, self.mesh.group(axes), op)


    def gather(self, x: torch.Tensor, dims: Dict[int, MeshAxes]
               ) -> torch.Tensor:
        """The whole tensor from every member's block, in one all_gather:
        ``dims`` maps each dimension of ``x`` that is a block to the mesh
        axis (or the axes, major first) it is split over (axes of one rank
        are skipped)."""
        on = {d % x.ndim: tuple(a for a in self.mesh.ordered(axes)
                                if self.size(a) > 1)
              for d, axes in dims.items()}
        on = {d: axes for d, axes in on.items() if axes}
        axes = self.mesh.ordered({a for part in on.values() for a in part})
        if not axes:
            return x
        stacked = gather(x, self.mesh.group(axes)).view(
            *(self.size(a) for a in axes), *x.shape)
        perm, shape = [], []
        for j, n in enumerate(x.shape):
            for a in on.get(j, ()):
                perm.append(axes.index(a))
                n *= self.size(a)
            perm.append(len(axes) + j)
            shape.append(n)
        return stacked.permute(perm).reshape(shape)

    def gather_last(self, *xs: torch.Tensor):
        """Tensors whose last dimension is a ``model`` block, each made
        whole, through one all_gather of their concatenation (in the
        widest of their types; each comes back in its own)."""
        widths = [x.shape[-1] for x in xs]
        stacked = gather(torch.cat(xs, dim=-1), self.mesh.group("model"))
        out = []
        for part, x in zip(stacked.split(widths, dim=-1), xs):
            part = part.movedim(0, -2)
            out.append(part.reshape(*part.shape[:-2], -1).to(x.dtype))
        return out


def serving() -> Optional[Shards]:
    return getattr(_STATE, "shards", None)


def enter_blocks(x: torch.Tensor) -> torch.Tensor:
    """``x``, whole on every rank, where it feeds the rank's block of work
    over ``model``: its gradient summed over ``model`` in the backward
    where autograd records (:func:`repro_torch.sharding.collectives.
    enter`), ``x`` itself where it does not (serving, whose shards are
    not asked for a group)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return enter(x, serving().mesh.group("model"))


@contextlib.contextmanager
def use_serving(shards: Optional[Shards]):
    prev = serving()
    _STATE.shards = shards
    try:
        yield shards
    finally:
        _STATE.shards = prev
