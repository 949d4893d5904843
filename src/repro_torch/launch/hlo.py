"""The census of one traced call: FLOPs, bytes, collectives, host
transfers, ops and memory of a step of the port — the reference's
``repro.launch.hlo``.

The reference reads the compiled HLO module (``cost_analysis()``,
``memory_analysis()`` and the module text).  The port runs eagerly, so
there is no module to read: :func:`census` runs the call once under a
``TorchDispatchMode`` that sees every aten op the call issues, with real
tensors or with fake ones (``FakeTensorMode``, where nothing is allocated
and no kernel runs), and counts as it goes.  Python loops are unrolled by
running them: every layer of a step is counted (the reference counts a
scan body once and multiplies it in the roofline).

* **Products** are counted by the formulas of
  ``torch.utils.flop_counter`` (the registry ``FlopCounterMode`` reads):
  2·M·N·K for a dot, as XLA counts it.  They are split by operand type:
  bf16/f16/fp8 products run on the tensor cores (``flops_bf16``), the rest
  outside them (``flops_f32``; the default matmul precision uses no TF32).
  ``product_flops`` sums the products and the kernels.
* **Elementwise and reduction ops**: one flop per output element of an
  arithmetic op and per input element of a reduction, in ``flops_f32``
  (they run outside the tensor cores whatever their type); a
  transcendental (exp, log, sigmoid, rsqrt...) counts in
  ``transcendentals`` instead, as XLA's cost analysis counts it.  Data
  movement (copies, casts, gathers, scatters, fills) costs no flop.
* **The kernels** (``repro_torch::`` ops) are counted by their module's
  ``cost`` (:data:`repro_torch.kernels.build.COSTS`), a function of the
  shapes and types alone, so the plain version on the CPU and the kernel
  on the card are one node with one count.  Any other ``repro_torch::``
  op raises: nothing is counted as free.
* **Bytes** are each op's inputs plus its outputs (a view moves nothing; a
  gather reads its indices and as many values as it writes, a scatter its
  indices and its updates, as XLA's cost analysis counts them).  An
  eager op reads and writes HBM, so this is what the eager step moves;
  fused code would move less, and like the reference's it is an upper
  bound on what the work needs.
* **Collectives** are what :func:`repro_torch.sharding.collectives.
  observe_collectives` sees, each by the bytes of its output (the
  reference's ``collective_bytes``), under the reference's kind names;
  the c10d ops they issue are not counted as ops.
* **Host transfers**: an op in :data:`HOST_OPS` (a scalar read, a
  data-dependent shape) or a copy between the host and a device.
* **Memory**: the storages the arguments hold, the new storages of the
  outputs, and the peak of every live storage during the call (views and
  in-place results alias their base: storages are tracked, not tensors).
  The bytes of the argument storages that ops read, each byte once
  (``argument_read_bytes``: a storage no op reads counts 0, a gather's
  source as many values as it gathers, a kernel op's inputs whole; a range
  starts at the view's offset), and that ops write in place
  (``argument_written_bytes``: a scatter its updates).  With ``output_bytes`` they are the step's traffic with each
  byte moved once, which does not move with how the ops are fused
  (:func:`repro_torch.launch.roofline.cell_roofline`'s ``floor_s``).
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.build import COSTS
from repro_torch.sharding.collectives import observe_collectives

#: ops whose result the host must see (a scalar, or a data-dependent shape)
HOST_OPS = ("aten._local_scalar_dense", "aten.item", "aten.nonzero",
            "aten.masked_select", "aten._unique", "aten._unique2",
            "aten.unique_dim", "aten.unique_consecutive")

#: the reference's ``_DTYPE_BYTES`` as torch types, the float8 types with
#: it (the types this torch build has)
DTYPE_BYTES = {getattr(torch, name): n for name, n in (
    ("bool", 1), ("int8", 1), ("uint8", 1), ("int16", 2), ("uint16", 2),
    ("bfloat16", 2), ("float16", 2), ("int32", 4), ("uint32", 4),
    ("float32", 4), ("int64", 8), ("uint64", 8), ("float64", 8),
    ("complex64", 8), ("complex128", 16), ("float8_e4m3fn", 1),
    ("float8_e5m2", 1), ("float8_e4m3fnuz", 1), ("float8_e5m2fnuz", 1))
    if hasattr(torch, name)}
#: operand types whose products run on the tensor cores
TENSOR_CORE_TYPES = tuple(getattr(torch, name) for name in (
    "bfloat16", "float16", "float8_e4m3fn", "float8_e5m2")
    if hasattr(torch, name))

#: :func:`observe_collectives`' names -> the reference's kinds
COLLECTIVE_KINDS = {"all_gather": "all-gather", "all_reduce_sum": "all-reduce",
                    "all_reduce_max": "all-reduce",
                    "ring_shift": "collective-permute",
                    # one member's tensor to every member: the point-to-point
                    # move XLA stages as a collective-permute
                    "broadcast": "collective-permute"}

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sigmoid",
    "tanh", "rsqrt", "sqrt", "pow", "erf", "erfc", "erfinv", "sin", "cos",
    "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "softplus",
    "silu", "gelu", "mish", "elu", "logit", "_softmax", "_log_softmax",
    "logsumexp"}
#: flops beside the transcendental of an op that XLA expands: SiLU is
#: x / (1 + exp(-x)) (negate, add, divide, multiply), a softmax subtracts
#: the row's max, sums and divides
_EXTRA_FLOPS = {"silu": 4, "sigmoid": 3, "gelu": 4, "softplus": 2, "mish": 4,
                "elu": 2, "_softmax": 4, "_log_softmax": 4, "logsumexp": 3}
#: reductions (with those torch tags so): one flop an input element
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "prod", "any", "all", "var", "std", "cumsum",
               "cumprod", "cummax", "cummin", "topk", "sort", "argsort",
               "_softmax", "_log_softmax", "logsumexp", "linalg_vector_norm",
               "var_mean", "std_mean", "kthvalue", "median", "mode"}
_REDUCTION_TAG = getattr(torch.Tag, "reduction", None)
#: data movement: no flop even where torch tags the op pointwise
_MOVES = {"copy", "copy_", "_to_copy", "clone", "fill", "fill_", "zero",
          "zero_", "lift_fresh_copy", "_copy_from", "_copy_from_and_resize",
          "masked_fill", "masked_fill_"}
_COPIES = {"copy_", "_to_copy", "clone", "cat", "stack", "repeat", "flip",
           "roll", "constant_pad_nd", "slice_scatter", "select_scatter",
           "diagonal_scatter", "as_strided_scatter", "_copy_from",
           "_copy_from_and_resize", "lift_fresh_copy", "repeat_interleave",
           "expand_copy", "permute_copy", "view_copy", "tril", "triu"}
_GATHERS = {"index": (1,), "_unsafe_index": (1,), "index_select": (2,),
            "embedding": (1,), "gather": (2,), "take": (1,),
            "take_along_dim": (1,)}
#: scatters: (updates argument, index arguments)
_SCATTERS = {"index_put": (2, (1,)), "index_put_": (2, (1,)),
             "_index_put_impl_": (2, (1,)), "index_copy": (3, (2,)),
             "index_copy_": (3, (2,)), "index_add": (3, (2,)),
             "index_add_": (3, (2,)), "scatter": (3, (2,)),
             "scatter_": (3, (2,)), "scatter_add": (3, (2,)),
             "scatter_add_": (3, (2,)), "scatter_reduce": (3, (2,)),
             "scatter_reduce_": (3, (2,)), "index_reduce": (3, (2,)),
             "index_reduce_": (3, (2,)), "masked_scatter": (2, (1,)),
             "masked_scatter_": (2, (1,)), "index_fill": (None, (2,)),
             "index_fill_": (None, (2,)),
             "embedding_dense_backward": (0, (1,))}
#: ops that write their output without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "_copy_from",
               "_copy_from_and_resize"}
#: factories that write nothing (their values are undefined)
_UNWRITTEN = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "empty_permuted"}
#: aliasing ops torch does not mark as views
_ALIASES = {"_unsafe_view", "alias", "lift_fresh", "detach", "_reshape_alias"}
_HOST_COPIES = {"_to_copy", "copy_", "_copy_from", "_copy_from_and_resize"}
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "c10d_functional")


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements take, at most its storage's (an
    expanded tensor reads its storage once)."""
    n = t.numel() * DTYPE_BYTES[t.dtype]
    try:
        return min(n, t.untyped_storage().nbytes())
    except (NotImplementedError, RuntimeError):
        return n


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None


class Census(TorchDispatchMode):
    """Counts every op the code issues while it is active (a dispatch
    mode; enter it with ``with``), and every collective
    :func:`observe_collectives` sees.  ``args`` are the call's arguments:
    their storages are live from the start.  :meth:`record` gives the
    record."""

    def __init__(self, args=()):
        super().__init__()
        self.cost = {"flops": 0, "flops_bf16": 0, "flops_f32": 0,
                     "product_flops": 0, "bytes_accessed": 0,
                     "transcendentals": 0}
        self.ops: Dict[str, int] = {"products": 0, "gathers": 0,
                                    "scatters": 0, "copies": 0,
                                    "kernels": 0, "total": 0}
        self.coll: Dict[str, float] = {}
        self.host: List[str] = []
        self._live: Dict[int, int] = {}
        self._arg_ids = set()
        #: argument storage -> the byte ranges ops read of it / wrote in it
        self._arg_read: Dict[int, set] = {}
        self._arg_written: Dict[int, set] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        for t in _tensors(args):
            key = self._track(t)
            if key is not None:
                self._arg_ids.add(key)
        self.argument_bytes = self.live_bytes
        self.peak_bytes = self.live_bytes
        self._observer = observe_collectives(self._collective)

    def __enter__(self):
        self._observer.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._observer.__exit__(*exc)

    # -- storages -----------------------------------------------------------
    def _track(self, t: torch.Tensor):
        """Add ``t``'s storage to the live set (once); returns its key."""
        s = _storage(t)
        if s is None:
            return None
        key = id(s)
        if key not in self._live:
            nbytes = s.nbytes()
            self._live[key] = nbytes
            self.live_bytes += nbytes
            weakref.finalize(s, self._free, key)
        return key

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- collectives --------------------------------------------------------
    def _collective(self, op: str, tensors) -> None:
        kind = COLLECTIVE_KINDS[op]
        nbytes = _tensor_bytes(tensors[-1])
        self.coll[f"{kind}_bytes"] = self.coll.get(f"{kind}_bytes", 0.0) \
            + nbytes
        self.coll[f"{kind}_count"] = self.coll.get(f"{kind}_count", 0.0) + 1
        self.coll["total_bytes"] = self.coll.get("total_bytes", 0.0) + nbytes

    # -- ops ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, _, rest = func.name().partition("::")
        if ns not in _COLLECTIVE_NS:
            self._count(func, ns, rest.split(".")[0], args, kwargs, out)
            for t in _tensors(out):
                self._track(t)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out

    def _count(self, func, ns, name, args, kwargs, out) -> None:
        full = f"{ns}.{name}"
        if func.is_view or name in _ALIASES:
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if full in HOST_OPS or (name in _HOST_COPIES and _crosses_host(
                ins, outs)):
            self.host.append(full)
        if not outs:    # a scalar or a device read off a tensor's metadata
            return
        self.ops["total"] += 1
        self._note_argument_traffic(name, args, ins, outs)
        if ns == "repro_torch":
            if full not in COSTS:
                raise NotImplementedError(
                    f"the census has no cost formula for {full}: give its "
                    "define_op a cost")
            c = COSTS[full](*args, **kwargs)
            self._flops(c.flops, c.tensor_cores)
            self.cost["product_flops"] += c.flops
            self.cost["bytes_accessed"] += c.bytes
            self.ops["kernels"] += 1
            self.ops[full] = self.ops.get(full, 0) + 1
            return
        self.cost["bytes_accessed"] += self._bytes(name, args, ins, outs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.ops["products"] += 1
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            floats = [t.dtype for t in ins if t.is_floating_point()]
            self._flops(flops, bool(floats) and all(
                d in TENSOR_CORE_TYPES for d in floats))
            self.cost["product_flops"] += flops
            return
        if name in _GATHERS:
            self.ops["gathers"] += 1
            return
        if name in _SCATTERS:
            self.ops["scatters"] += 1
            return
        if name in _COPIES:
            self.ops["copies"] += 1
        if name in _MOVES or not outs:
            return
        tags = func.tags
        if name in _REDUCTIONS or _REDUCTION_TAG in tags:
            n = ins[0].numel() if ins else 0
        elif torch.Tag.pointwise in tags:
            n = outs[0].numel()
        else:
            return
        if name in _TRANSCENDENTAL:
            self.cost["transcendentals"] += n
            self._flops(n * _EXTRA_FLOPS.get(name, 0), False)
        else:
            self._flops(n, False)

    def _note_argument_traffic(self, name, args, ins, outs) -> None:
        """Note the byte ranges of argument storages an op reads (from the
        view's offset: its elements, or for a gather's source as many
        values as it gathers) and writes in place (a scatter: its
        updates)."""
        if name in _UNWRITTEN:
            return
        into = _tensors(args[0]) if args and (
            name in _WRITE_ONLY or name in _SCATTERS and name.endswith("_")
        ) else []
        src = _tensors(args[0]) if name in _GATHERS and args else []
        for t in ins:
            if not any(t is x for x in into):
                n = (sum(map(_tensor_bytes, outs)) if any(t is x for x in src)
                     else _tensor_bytes(t))
                self._note_range(self._arg_read, t, n)
        upd = _SCATTERS.get(name, (None,))[0]
        for t in outs:
            vals = (_tensors(args[upd]) if upd is not None and upd < len(args)
                    else [t])
            self._note_range(self._arg_written, t, sum(map(_tensor_bytes,
                                                           vals)))

    def _note_range(self, ranges: Dict[int, set], t: torch.Tensor,
                    n: int) -> None:
        s = _storage(t)
        key = None if s is None else id(s)
        if key in self._arg_ids and key in self._live:
            start = t.storage_offset() * DTYPE_BYTES[t.dtype]
            ranges.setdefault(key, set()).add((start, start + n))

    def _range_bytes(self, ranges: Dict[int, set]) -> int:
        """The bytes the ranges cover, each storage's at most its size."""
        total = 0
        for key, spans in ranges.items():
            covered, end = 0, 0
            for a, b in sorted(spans):
                covered += max(b - max(a, end), 0)
                end = max(end, b)
            total += min(covered, self._live.get(key, covered))
        return total

    def _flops(self, n: int, tensor_cores: bool) -> None:
        self.cost["flops"] += n
        self.cost["flops_bf16" if tensor_cores else "flops_f32"] += n

    @staticmethod
    def _bytes(name, args, ins, outs) -> int:
        if name in _UNWRITTEN:
            return 0
        if name in _GATHERS:
            idx = [t for i in _GATHERS[name] if i < len(args)
                   for t in _tensors(args[i])]
            return 2 * sum(map(_tensor_bytes, outs)) + sum(map(_tensor_bytes,
                                                              idx))
        if name in _SCATTERS and name.endswith("_") or name in (
                "embedding_dense_backward",):
            upd, idx_args = _SCATTERS[name]
            idx = [t for i in idx_args if i < len(args)
                   for t in _tensors(args[i])]
            vals = _tensors(args[upd]) if upd is not None and upd < len(
                args) else outs
            return 2 * sum(map(_tensor_bytes, vals)) + sum(map(_tensor_bytes,
                                                              idx))
        if name in _WRITE_ONLY:
            ins = ins[1:]
        return sum(map(_tensor_bytes, ins)) + sum(map(_tensor_bytes, outs))

    # -- the record ---------------------------------------------------------
    def record(self, out=None) -> Dict:
        """The reference's record parts: ``cost``, ``collectives``,
        ``ops``, ``host_transfers`` (the op names) and ``memory``
        (``output_bytes`` the new storages of ``out``)."""
        out_ids = {id(s) for s in map(_storage, _tensors(out))
                   if s is not None}
        output_bytes = sum(self._live.get(k, 0) for k in out_ids
                           if k not in self._arg_ids)
        peak = self.peak_bytes
        return {
            "cost": {k: float(v) for k, v in self.cost.items()},
            "collectives": dict(self.coll, total_bytes=self.coll.get(
                "total_bytes", 0.0)),
            "ops": dict(self.ops),
            "host_transfers": list(self.host),
            "memory": {
                "argument_bytes": float(self.argument_bytes),
                "argument_read_bytes": float(self._range_bytes(
                    self._arg_read)),
                "argument_written_bytes": float(self._range_bytes(
                    self._arg_written)),
                "output_bytes": float(output_bytes),
                "temp_bytes": float(max(peak - self.argument_bytes
                                        - output_bytes, 0)),
                "peak_bytes_est": float(peak)},
        }


def _crosses_host(ins, outs) -> bool:
    devices = {t.device.type for t in ins + outs}
    return "cpu" in devices and len(devices) > 1


def _fake_mode_of(tree):
    """The fake mode of the first fake tensor in ``tree`` (a context to
    run code on those tensors in, so that what it makes is fake too), or a
    null context where none is fake."""
    for t in _tensors(tree):
        mode = getattr(t, "fake_mode", None)
        if mode is not None:
            return mode
    return contextlib.nullcontext()


def census(fn: Callable, *args) -> Dict:
    """Run ``fn(*args)`` once and count it (:class:`Census`): the
    reference's record parts ``cost``, ``collectives``, ``ops``,
    ``host_transfers`` and ``memory``.  On fake arguments the call runs in
    their fake mode, so nothing it makes is allocated either."""
    with _fake_mode_of(args), Census(args) as c:
        out = fn(*args)
    return c.record(out)


def counted_flops(fn: Callable, *args) -> float:
    """The FLOPs of one call (the reference's ``compiled_flops``)."""
    return census(fn, *args)["cost"]["flops"]
