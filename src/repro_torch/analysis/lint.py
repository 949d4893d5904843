"""Sparsity-invariant linting of the port's entry points (the counterpart
of the reference's ``repro.analysis.lint``).

Library API
-----------
* :func:`lint_fn` — trace any callable on fake tensors
  (:func:`~.graph_walk.trace`) and run the graph rule pack over it.
* :func:`lint_config` — lint a configuration's entry points (the decode
  step, the paged decode step, the fused prefill, the kwta→packed
  projection pipeline, the training loss) with params and caches made as
  fake tensors, so a full-scale configuration lints on the CPU without
  allocating a weight.
  The decode steps are also held to the host-transfer and collective
  rules (the reference's HLO rules).
* :func:`expected_selects` — the Select-count model, the reference's
  copied over the port's :func:`~repro_torch.core.api.choose_path`.
* :func:`lint_kernels` — the guarded kernel checks
  (:mod:`.kernel_checks`) and the launch-resource rule over the four
  shipped kernels at the registry sweeps and at the serving shapes.
* :func:`seeded_regressions` — deliberately broken pipelines (a doubled
  Select; a float64 scalar in the support's path; the off-by-one gather
  kernel; the accumulation kernel with no init) that the CLI's
  ``--self-test`` and the tests use to prove the linter catches them.

Every function takes ``device``: ``None`` is ``cuda``, as for the port's
other entry points, and raises where there is no card; the tests pass
``"cpu"``.  Fake-tensor traces take that device; the kernel checks launch
the CUDA kernels there, or run their plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import functional as F
from repro_torch.core.api import SparsityConfig, choose_executor, choose_path
from repro_torch.core.instrument import named_scope
from repro_torch.core.masks import pad_to_multiple
from repro_torch.kernels import registry
from repro_torch.models.common import resolve_device
from repro_torch.tree import fake

from . import seeded
from .findings import Report
from .graph_rules import (rule_collectives, rule_host_transfer,
                          trace_error_finding)
from .graph_walk import trace
from .kernel_checks import Case, check_cases
from .rules import (check_geometry, kernel_geometry, rule_dense_fallback,
                    rule_dtype_promotion, rule_launch_resource,
                    rule_select_count)

#: the reference's entry points, every one ported
ENTRIES = ("decode", "decode_paged", "prefill", "kernel", "train")
#: what :func:`lint_config` lints by default: the serving entries (``train``
#: on request)
PORTED_ENTRIES = ("decode", "decode_paged", "prefill", "kernel")


def linting_device(device=None) -> torch.device:
    """``cuda`` unless ``device`` says otherwise; a CUDA device where
    there is none raises, as the port's entry points do."""
    device = resolve_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to lint on the CPU")
    return device


# ---------------------------------------------------------------------------
# The Select-count model (the reference's, over the port's dispatch)
# ---------------------------------------------------------------------------

def family_path(sp: SparsityConfig, n_tokens: int, d_in: int,
                d_out: int) -> Optional[str]:
    """Execution path the packed projection consuming the k-WTA output
    will take, or None when the projection isn't CS-packed."""
    if not (sp.weight_sparse and d_in % sp.n == 0 and d_out % sp.n == 0):
        return None
    d_in_p = pad_to_multiple(d_in, sp.n)
    return choose_path(sp, n_tokens, d_in_p, x_is_sparse=sp.activation_sparse)


def family_selects(sp: SparsityConfig, n_tokens: int, d_in: int,
                   d_out: int) -> int:
    """Selects staged by one kwta→packed-projection pipeline.

    Mirrors ``apply_kwta`` + ``packed_linear_apply``: the k-WTA runs a
    ``topk`` unless it runs the histogram/bisection datapath; the
    downstream projection re-derives the support (one more ``topk``)
    only on the topk path when no ``(vals, idx)`` handoff exists — the
    handoff exists only for the exact global top-k impl."""
    if not sp.activation_sparse:
        return 0
    k = sp.k_for(d_in)
    if k >= d_in:
        return 0
    kwta_runs_topk = sp.kwta_impl not in ("hist", "bisect")
    has_support = kwta_runs_topk and sp.kwta_partitions <= 1
    n_sel = 1 if kwta_runs_topk else 0
    if family_path(sp, n_tokens, d_in, d_out) == "topk" and not has_support:
        n_sel += 1
    return n_sel


def expected_selects(cfg, n_tokens: int) -> Optional[Dict[str, int]]:
    """Per-layer-key Select expectation for a model config, or None when
    the config is un-modeled (MoE routers run their own top-k)."""
    if cfg.is_moe:
        return None
    exp: Dict[str, int] = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind not in ("attn", "shared_attn"):
            continue
        if cfg.d_ff > 0:
            exp[f"b{i}_{kind}/ffn"] = family_selects(
                cfg.ffn_sparsity, n_tokens, cfg.d_ff, cfg.d_model)
        if cfg.proj_sparsity.activation_sparse:
            exp[f"b{i}_{kind}/o_proj"] = family_selects(
                cfg.proj_sparsity, n_tokens,
                cfg.padded_heads * cfg.head_dim, cfg.d_model)
    return exp


def _on_topk(sp: SparsityConfig, n_tokens: int, d_in: int,
             d_out: int) -> bool:
    return bool(sp.activation_sparse and d_in
                and choose_executor(sp).use_kernel
                and family_path(sp, n_tokens, d_in, d_out) == "topk")


def _wants_dense_fallback_rule(cfg, n_tokens: int) -> bool:
    """The dense-fallback rule only means something where a sparse family
    is configured to hit the kernel's topk path: in the Hadamard/dense
    regimes a dense product on the k-sparse activation IS the sanctioned
    algorithm."""
    if cfg.is_moe:
        return False
    return (_on_topk(cfg.ffn_sparsity, n_tokens, cfg.d_ff, cfg.d_model)
            or _on_topk(cfg.proj_sparsity, n_tokens,
                        cfg.padded_heads * cfg.head_dim, cfg.d_model))


# ---------------------------------------------------------------------------
# lint_fn: the library core
# ---------------------------------------------------------------------------

def lint_fn(fn: Callable, *example_args,
            entry: str = "fn",
            expected: Optional[Dict[str, int]] = None,
            check_select: bool = True,
            check_dense_fallback: bool = False,
            check_dtype: bool = True,
            check_launch: bool = True,
            check_host: bool = False,
            waivers: Sequence[str] = ()) -> Report:
    """Trace ``fn`` on fake tensors and lint the graph.

    ``example_args`` may be real or fake tensors in nested dicts and
    lists — tracing never runs a kernel or touches a value.  A trace that
    stops because the code asks for a tensor's value is a
    ``host-transfer`` finding.  Returns a :class:`Report`; ``report.ok``
    is the one-line "zero findings" assertion."""
    report = Report(entries=[entry])
    try:
        gm = trace(fn, *example_args)
    except RuntimeError as e:
        finding = trace_error_finding(e, entry)
        if finding is None:
            raise
        report.add([finding], waivers)
        return report
    if check_select:
        report.add(rule_select_count(gm, expected, entry), waivers)
    if check_dense_fallback:
        report.add(rule_dense_fallback(gm, entry), waivers)
    if check_dtype:
        report.add(rule_dtype_promotion(gm, entry), waivers)
    if check_launch:
        report.add(rule_launch_resource(gm, entry), waivers)
    if check_host:
        report.add(rule_host_transfer(gm, entry), waivers)
        report.add(rule_collectives(gm, entry), waivers)
    return report


# ---------------------------------------------------------------------------
# lint_config: lint a configuration's entry points on fake tensors
# ---------------------------------------------------------------------------

def _with_pallas_mode(cfg, mode: Optional[str]):
    if mode is None:
        return cfg
    return dataclasses.replace(
        cfg,
        ffn_sparsity=dataclasses.replace(cfg.ffn_sparsity, use_pallas=mode),
        proj_sparsity=dataclasses.replace(cfg.proj_sparsity,
                                          use_pallas=mode))


def resolve_config(arch, use_pallas: Optional[str] = "force",
                   reduced: bool = False):
    """A config name or ``ModelConfig``, reduced and with its executor
    mode set, as :func:`lint_config` lints it; a block kind the reference
    does not know raises ``ValueError``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    T.check_supported(cfg)
    return _with_pallas_mode(cfg, use_pallas)


def _decode_batch(cfg, slots: int):
    if cfg.frontend == "embed":
        return {"embeds": torch.empty((slots, 1, cfg.d_model))}
    return {"tokens": torch.zeros((slots, 1), dtype=torch.int64)}


def _seq_batch(cfg, batch: int, seq: int, labels: bool):
    """A sequence batch of the config's frontend (the reference's
    ``_seq_batch``): tokens or embeds, a vision prefix's patch
    embeddings, the labels of a training batch."""
    out = {}
    if cfg.frontend == "embed":
        out["embeds"] = torch.empty((batch, seq, cfg.d_model))
    else:
        out["tokens"] = torch.zeros((batch, seq), dtype=torch.int64)
    if cfg.frontend == "vision_prefix":
        out["patch_embeds"] = torch.empty((batch, cfg.n_prefix, cfg.d_model))
    if labels:
        out["labels"] = torch.zeros((batch, seq), dtype=torch.int64)
    return out


def entry_args(cfg, entry: str, device, slots: int = 4, seq: int = 8,
               max_seq: int = 64):
    """(fn, fake args) of one entry point at full or reduced scale; the
    batches take the config's frontend."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime.kvcache.layout import PagedKV
    if entry not in ENTRIES:
        raise ValueError(f"unknown entry {entry!r}; known: {ENTRIES}")
    if entry == "kernel":
        return pipeline_args(cfg.ffn_sparsity, slots, cfg.d_ff, cfg.d_model,
                             device)

    def params():
        return T.init_model(cfg, seed=0, device="cpu")

    def positions():
        return torch.zeros((slots,), dtype=torch.int64)

    if entry == "prefill":
        return (lambda p, b: T.prefill(p, b, cfg, max_seq)[0],
                fake(lambda: (params(), _seq_batch(cfg, 1, seq, False)),
                     device))
    if entry == "train":
        # the forward of the loss on the training layout, two sequences
        return (lambda p, b: T.loss_fn(p, b, cfg)[0],
                fake(lambda: (T.init_train_params(cfg, seed=0, device="cpu"),
                              _seq_batch(cfg, 2, seq, True)), device))
    if entry == "decode":
        return (lambda p, c, b, q: T.serve_step(p, c, b, q, cfg)[0],
                fake(lambda: (params(), T.init_cache(cfg, slots, max_seq,
                                                     "cpu"),
                              _decode_batch(cfg, slots), positions()),
                     device))
    geo = PagedKV.build(max_seq, slots, page_size=16)
    return (lambda p, c, b, q, pg: T.serve_step(p, c, b, q, cfg,
                                                pages=pg)[0],
            fake(lambda: (params(), T.init_paged_cache(
                cfg, geo.n_pages, geo.page_size, "cpu"),
                _decode_batch(cfg, slots), positions(),
                torch.zeros((slots, geo.blocks_per_slot),
                            dtype=torch.int64)), device))


def lint_config(arch, entries: Sequence[str] = PORTED_ENTRIES,
                use_pallas: Optional[str] = "force",
                slots: int = 4, seq: int = 8, max_seq: int = 64,
                reduced: bool = False, check_host: bool = True,
                device=None, waivers: Sequence[str] = ()) -> Report:
    """Lint the named (or given) model config's entry points on fake
    tensors.

    ``arch`` is a config name (``smollm-360m``) or a ``ModelConfig``.
    ``use_pallas`` overrides both sparsity families' executor flag
    (default ``"force"``: the kernel path); ``None`` keeps the config's
    own.  ``check_host`` holds the decode steps to the host-transfer and
    collective rules.  ``train`` lints the forward of ``loss_fn`` on the
    training layout over two sequences of ``seq`` tokens (the
    dense-fallback rule off, as the reference's).  As in the reference,
    ``decode_paged`` and ``prefill`` are skipped for patterns with SSM
    blocks (no paged layout, no fused prefill)."""
    from repro_torch.models import transformer as T
    device = linting_device(device)
    cfg = resolve_config(arch, use_pallas, reduced)
    report = Report()
    for entry in entries:
        if (entry in ("decode_paged", "prefill")
                and not T.supports_fused_prefill(cfg)):
            continue
        if entry == "kernel":
            if cfg.d_ff > 0:
                report.extend(lint_kernel_pipeline(
                    cfg.ffn_sparsity, slots, cfg.d_ff, cfg.d_model,
                    device=device, waivers=waivers))
            continue
        fn, args = entry_args(cfg, entry, device, slots, seq, max_seq)
        n_tokens = {"prefill": seq, "train": 2 * seq}.get(entry, slots)
        report.extend(lint_fn(
            fn, *args, entry=entry,
            expected=expected_selects(cfg, n_tokens),
            # the reference's train entry skips it (backward not linted)
            check_dense_fallback=(entry != "train" and
                                  _wants_dense_fallback_rule(cfg, n_tokens)),
            check_host=check_host and entry.startswith("decode"),
            waivers=waivers))
    return report


def pipeline_args(sp: SparsityConfig, n_tokens: int, d_in: int,
                  d_out: int, device):
    """(fn, fake args) of the bare kwta→packed-projection pipeline, the
    ``kernel`` entry."""
    from repro_torch.core.layers import (apply_kwta, packed_linear_apply,
                                         packed_linear_init)

    def fn(p, x):
        with named_scope("ffn_kwta"):
            h, support = apply_kwta(x, sp, return_support=True)
        with named_scope("ffn_down"):
            return packed_linear_apply(p, h, sp,
                                       x_is_sparse=sp.activation_sparse,
                                       support=support)

    return fn, fake(lambda: (packed_linear_init(
        torch.Generator(), d_in, d_out, sp, bias=False),
        torch.empty((n_tokens, d_in))), device)


def lint_kernel_pipeline(sp: SparsityConfig, n_tokens: int, d_in: int,
                         d_out: int, device=None,
                         waivers: Sequence[str] = ()) -> Report:
    """Lint the bare kwta→packed-projection pipeline (the ``kernel``
    entry) at the given shapes."""
    if not (sp.weight_sparse and d_in % sp.n == 0 and d_out % sp.n == 0):
        return Report(entries=["kernel:skipped"])
    fn, args = pipeline_args(sp, n_tokens, d_in, d_out,
                             linting_device(device))
    return lint_fn(fn, *args, entry="kernel",
                   expected={"ffn": family_selects(sp, n_tokens, d_in,
                                                   d_out)},
                   check_dense_fallback=_on_topk(sp, n_tokens, d_in, d_out),
                   waivers=waivers)


# ---------------------------------------------------------------------------
# lint_kernels: guarded launches of the shipped kernels
# ---------------------------------------------------------------------------

def _draw(gen, shape, lo: int, hi: int, dtype):
    """Integers in [lo, hi] with both ends present (first and last)."""
    t = torch.randint(lo, hi + 1, shape, generator=gen)
    t.view(-1)[0], t.view(-1)[-1] = lo, hi
    return t.to(dtype)


def _cpu_or(launch_into, plain):
    """A case's run: the kernel into its output on CUDA operands, the plain
    version's result copied there on CPU operands."""
    def run(outs, *ins):
        if ins[0].device.type == "cpu":
            outs[0].copy_(plain(*ins))
        else:
            launch_into(outs[0], *ins)
    return run


def topk_gather_case(b, k, p, g, n, dtype, idx_dtype, device, seed=0):
    from repro_torch.kernels.topk_gather import launch_into, topk_gather_plain
    gen = torch.Generator().manual_seed(seed)
    ins = [torch.randn((b, k), generator=gen).to(dtype),
           _draw(gen, (b, k), 0, p - 1, idx_dtype),
           _draw(gen, (b, k), 0, n - 1, idx_dtype),
           torch.randn((p, g, n), generator=gen).to(dtype),
           _draw(gen, (1, p, n), 0, n - 1, torch.int8)]
    run = _cpu_or(launch_into, lambda *a: topk_gather_plain(
        *a, out_dtype=dtype))
    return Case("topk_gather", f"topk_gather(B={b}, K={k}, P={p}, G={g}, "
                f"N={n}, {str(dtype)[6:]}, {str(idx_dtype)[6:]})", run,
                [t.to(device) for t in ins], [((b, g * n), dtype)])


def packed_matmul_case(b, p, g, n, dtype, device, seed=0):
    from repro_torch.kernels.packed_matmul import (launch_into,
                                                   packed_matmul_plain)
    gen = torch.Generator().manual_seed(seed)
    ins = [torch.randn((b, p * n), generator=gen).to(dtype),
           torch.randn((g, p, n), generator=gen).to(dtype),
           _draw(gen, (1, p, n), 0, n - 1, torch.int8)]
    return Case("packed_matmul", f"packed_matmul(B={b}, P={p}, G={g}, N={n},"
                f" {str(dtype)[6:]})",
                _cpu_or(launch_into, packed_matmul_plain),
                [t.to(device) for t in ins], [((b, g * n), torch.float32)])


def grouped_cs_matmul_case(n, b, p, g, dtype, device, seed=0):
    from repro_torch.kernels.grouped_cs_matmul import (
        grouped_cs_matmul_plain, launch_into)
    gen = torch.Generator().manual_seed(seed)
    ins = [torch.randn((n, b, p), generator=gen).to(dtype),
           torch.randn((n, p, g), generator=gen).to(dtype)]
    return Case("grouped_cs_matmul", f"grouped_cs_matmul(N={n}, B={b}, "
                f"P={p}, G={g}, {str(dtype)[6:]})",
                _cpu_or(launch_into, grouped_cs_matmul_plain),
                [t.to(device) for t in ins], [((n, b, g), torch.float32)])


def kwta_hist_case(b, d, k, dtype, device, seed=0):
    from repro_torch.kernels.kwta_hist import (kwta_hist_cuda_plain,
                                               launch_into)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, d), generator=gen).to(dtype)
    return Case("kwta_hist", f"kwta_hist(B={b}, D={d}, K={k}, "
                f"{str(dtype)[6:]})",
                _cpu_or(lambda y, x: launch_into(y, x, k),
                        lambda x: kwta_hist_cuda_plain(x, k)),
                [x.to(device)], [((b, d), dtype)])


#: smollm-360m's FFN at serving: d_model 960, d_ff 2560, N=4, K=320
SERVING_FFN = dict(d_model=960, d_ff=2560, n=4, k=320)


def kernel_cases(device, serving: bool = True,
                 dtypes=(torch.float32, torch.bfloat16)) -> List[Case]:
    """The shipped kernels' cases: the registry sweeps in every type of
    ``dtypes`` and, with ``serving``, the serving shapes (decode B = 1-7
    for ``topk_gather`` with the support as the layer hands it over, the
    products' up and down projections at T=4 and T=128, ``kwta_hist`` at
    (128, 2560))."""
    cases = []
    for dt in dtypes:
        for b, k, p, g, n, _ in registry.TOPK_GATHER_SWEEP:
            cases.append(topk_gather_case(b, k, p, g, n, dt, torch.int32,
                                          device))
        for b, p, g, n, *_ in registry.PACKED_MATMUL_SWEEP:
            cases.append(packed_matmul_case(b, p, g, n, dt, device))
        for n, b, p, g, *_ in registry.GROUPED_CS_SWEEP:
            cases.append(grouped_cs_matmul_case(n, b, p, g, dt, device))
        for b, d, k, _ in registry.KWTA_HIST_SWEEP:
            cases.append(kwta_hist_case(b, d, k, dt, device))
    if not serving:
        return cases
    d, f, n, k = (SERVING_FFN[x] for x in ("d_model", "d_ff", "n", "k"))
    for dt in dtypes:
        for b in range(1, 8):
            cases.append(topk_gather_case(b, k, f // n, d // n, n, dt,
                                          torch.int64, device))
        for t in (4, 128):
            for d_in, d_out in ((d, f), (f, d)):
                cases.append(packed_matmul_case(t, d_in // n, d_out // n, n,
                                                dt, device))
                cases.append(grouped_cs_matmul_case(n, t, d_in // n,
                                                    d_out // n, dt, device))
        cases.append(kwta_hist_case(128, f, k, dt, device))
    return cases


def lint_kernels(device=None, serving: bool = True,
                 dtypes=(torch.float32, torch.bfloat16),
                 waivers: Sequence[str] = ()) -> Report:
    """Check every shipped kernel at every case of :func:`kernel_cases`:
    the guarded launches (``oob-access``, ``grid-race``) and the
    launch-resource rule at each case's shapes."""
    device = linting_device(device)
    cases = kernel_cases(device, serving, dtypes)
    report = Report()
    entries, findings = check_cases(cases)
    report.entries.extend(entries)
    report.add(findings, waivers)
    for case, entry in zip(cases, entries):
        geo = kernel_geometry(f"repro_torch.{case.kernel}", case.inputs)
        report.add(check_geometry(case.kernel, geo, entry, case.label),
                   waivers)
    return report


# ---------------------------------------------------------------------------
# Seeded regressions (CLI --self-test; tests/test_torch_analysis.py)
# ---------------------------------------------------------------------------

def _regression_double_topk(device) -> Report:
    """A layer that ignores the k-WTA support handoff and re-derives it:
    two Selects where the paper's pipeline (Fig. 8a) runs one.  It runs
    the PyTorch formula (``use_pallas="off"``), as the reference's
    ``auto`` does off a TPU, so the support also meets a dense product
    (a ``dense-fallback`` finding beside the ``select-count`` one)."""
    from repro_torch.core.layers import (apply_kwta, packed_linear_apply,
                                         packed_linear_init)
    sp = SparsityConfig(n=4, k_frac=0.125, route_share=0, kwta_impl="topk",
                        use_pallas="off")
    d_in, d_out, tokens = 128, 64, 2
    params, x = fake(lambda: (packed_linear_init(
        torch.Generator(), d_in, d_out, sp, bias=False),
        torch.empty((tokens, d_in))), device)

    def bad(p, x):
        with named_scope("b0_attn"):
            with named_scope("ffn_kwta"):
                h, support = apply_kwta(x, sp, return_support=True)
            with named_scope("ffn_down"):
                # the fault under test: the handoff dropped, the projection
                # re-runs torch.topk on the already k-sparse activation
                return packed_linear_apply(p, h, sp, x_is_sparse=True,
                                           support=None)

    expected = {"b0_attn/ffn": family_selects(sp, tokens, d_in, d_out)}
    return lint_fn(bad, params, x, entry="decode", expected=expected,
                   check_dense_fallback=True, check_launch=False)


def _regression_f64_kernel(device) -> Report:
    """A float64 scalar in the support's path: every value it touches
    becomes float64."""
    x, packed, route = fake(lambda: (
        torch.empty((2, 32)), torch.empty((16, 8, 4)),
        torch.empty((16, 8, 4), dtype=torch.int8)), device)

    def bad(x, packed, route):
        with named_scope("b0_attn"), named_scope("ffn_down"), \
                named_scope("cs_topk"):
            vals, sel = F.topk_support_flat(x, 4)
            # the fault under test: a float64 scale drags the support's
            # values up to 64-bit
            vals = vals * torch.ones(1, dtype=torch.float64,
                                     device=vals.device)
            return F.cs_topk_from_support(vals, sel // 4, sel % 4, packed,
                                          route)

    return lint_fn(bad, x, packed, route, entry="kernel",
                   check_select=False, check_launch=False)


def oob_gather_case(device, seed=0) -> Case:
    """The seeded off-by-one gather at the reference's shape, its indices
    drawn over the declared range [0, P), P - 1 included."""
    b, k, p, g, n = (seeded.OOB_SHAPE[x] for x in "bkpgn")
    gen = torch.Generator().manual_seed(seed)
    ins = [torch.randn((b, k), generator=gen),
           _draw(gen, (b, k), 0, p - 1, torch.int32),
           torch.randn((p, g, n), generator=gen)]
    return Case("_oob_gather_kernel", f"oob_gather(B={b}, K={k}, P={p}, "
                f"G={g}, N={n})",
                lambda outs, *a: seeded.oob_gather_into(outs[0], *a),
                [t.to(device) for t in ins], [((b, g * n), torch.float32)])


def missing_init_case(device, seed=0) -> Case:
    """The seeded accumulation with no init, at the reference's shape."""
    s, m, k, c, bk = (seeded.MISSING_SHAPE[x] for x in
                      ("s", "m", "k", "c", "bk"))
    gen = torch.Generator().manual_seed(seed)
    ins = [torch.randn((s, m, k), generator=gen),
           torch.randn((s, k, c), generator=gen)]
    return Case("_missing_init_kernel", f"missing_init(S={s}, M={m}, K={k}, "
                f"C={c}, bk={bk})",
                lambda outs, *a: seeded.missing_init_into(outs[0], *a, bk),
                [t.to(device) for t in ins], [((s, m, c), torch.float32)])


def _regression_kernel(make_case) -> Callable:
    def run(device) -> Report:
        case = make_case(device)
        report = Report()
        entries, findings = check_cases([case], "kernel")
        report.entries.extend(entries)
        report.add(findings)
        return report
    return run


def seeded_regressions() -> Dict[str, Callable]:
    """Named deliberately-broken pipelines the linter must flag; each
    takes a device and returns a :class:`Report`."""
    return {"double-topk": _regression_double_topk,
            "f64-kernel": _regression_f64_kernel,
            "oob-gather": _regression_kernel(oob_gather_case),
            "missing-init": _regression_kernel(missing_init_case)}


def self_test(device=None) -> List[str]:
    """Run every seeded regression; return failure descriptions (empty
    when the linter caught all of them — the CI negative test)."""
    device = linting_device(device)
    expect_rule = {"double-topk": "select-count",
                   "f64-kernel": "dtype-promotion",
                   "oob-gather": "oob-access",
                   "missing-init": "grid-race"}
    # kernel findings must name the kernel AND the offending Ref
    expect_text = {"oob-gather": ("_oob_gather_kernel", "in[2]"),
                   "missing-init": ("_missing_init_kernel", "out[2]")}
    failures = []
    for name, run in seeded_regressions().items():
        report = run(device)
        rule = expect_rule[name]
        hits = report.by_rule(rule)
        if not hits:
            failures.append(
                f"seeded regression {name!r} was NOT caught (expected a "
                f"{rule} finding; got: {report.render()})")
            continue
        for needle in expect_text.get(name, ()):
            if not any(needle in f.message for f in hits):
                failures.append(
                    f"seeded regression {name!r}: the {rule} finding does "
                    f"not name {needle!r} (got: {hits[0].message})")
    return failures
