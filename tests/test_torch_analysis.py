"""The port's sparsity-invariant linter (``repro_torch.analysis``) beside
the reference's (``repro.analysis``): the Select model; the per-layer
Select counts of the port's traced entry points against the counts that
``iter_eqns`` + ``layer_key`` give on the reference's jaxprs of the same
entries; the taint engine and the dense-fallback rule on both packages'
doubled-Select regressions; the dtype, launch-resource and host-transfer
rules on small graphs; waivers; and the CLI's exit codes.

The reference's analyser fails some of its own tests under this jax
(``BlockMapping`` drift, ``enable_x64``); the functions used here
(``jax.make_jaxpr``, ``iter_eqns``, ``layer_key``, the Select model,
``rule_dense_fallback``) run.  Everything is traced on fake CPU tensors:
the counts and rules compare graphs, not numbers, so no tolerance
applies."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import jaxpr_walk as j_walk
from repro.analysis import lint as j_lint
from repro.analysis import rules as j_rules
from repro.configs import get_config as j_get_config
from repro.core.api import SparsityConfig as JSparsityConfig
from repro_torch.analysis import (Finding, Report, lint_config, lint_fn,
                                  propagate_taint, seeded_regressions,
                                  select_counts, trace)
from repro_torch.analysis import lint as t_lint
from repro_torch.analysis import rules as t_rules
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.graph_rules import rule_host_transfer
from repro_torch.analysis.graph_walk import op_name
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.api import SparsityConfig

CONFIGS = ("smollm_360m", "yi_6b", "minitron_8b", "starcoder2_15b")
SLOTS, SEQ, MAX_SEQ = 4, 8, 64


# ---------------------------------------------------------------------------
# The Select model
# ---------------------------------------------------------------------------

SP_GRID = [dict(n=n, k_frac=kf, route_share=0, kwta_impl=impl,
                kwta_partitions=parts)
           for n in (4, 32) for kf in (0.125, None)
           for impl in ("topk", "hist", "bisect") for parts in (0, 2)]
TOKENS = (1, 4, 8, 64, 512)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_select_model_equals_the_reference(arch):
    """family_path, family_selects and expected_selects give the
    reference's answers for every config of both registries, with each
    SparsityConfig of the grid on both families, at every token count."""
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    for fields in SP_GRID:
        jsp, tsp = JSparsityConfig(**fields), SparsityConfig(**fields)
        jc = dataclasses.replace(jcfg, ffn_sparsity=jsp, proj_sparsity=jsp)
        tc = dataclasses.replace(tcfg, ffn_sparsity=tsp, proj_sparsity=tsp)
        for t in TOKENS:
            assert t_lint.expected_selects(tc, t) == \
                j_lint.expected_selects(jc, t), (fields, t)
            for d_in, d_out in ((tcfg.d_ff, tcfg.d_model),
                                (tcfg.d_model, tcfg.d_ff), (128, 64)):
                if not d_in:
                    continue
                assert t_lint.family_path(tsp, t, d_in, d_out) == \
                    j_lint.family_path(jsp, t, d_in, d_out)
                assert t_lint.family_selects(tsp, t, d_in, d_out) == \
                    j_lint.family_selects(jsp, t, d_in, d_out)


def test_layer_key_is_the_reference_s():
    for path in ("b0_attn/ffn_down/cs_topk/select", "b1_attn/o_proj/select",
                 "b1_attn/transpose", "softmax", "ffn_kwta/select",
                 "u3/b1_attn/ffn_gate/cs_hadamard"):
        assert t_rules.layer_key(path) == j_rules.layer_key(path)
    assert t_rules.unit_of("u3/b1_attn/ffn_down") == "u3"
    assert t_rules.unit_of("b1_attn/ffn_down") == ""


# ---------------------------------------------------------------------------
# Per-layer Select counts against the reference's jaxprs
# ---------------------------------------------------------------------------

def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(tuple(shape), jnp.dtype(dtype))


def _reference_jaxpr(cfg, entry):
    """``jax.make_jaxpr`` of the reference's entry, built as its
    ``lint_config`` builds it (abstract params and caches)."""
    from repro.core.layers import (apply_kwta, packed_linear_apply,
                                   packed_linear_init)
    from repro.models import transformer as T
    from repro.runtime.kvcache import PagedKV
    key = jax.random.PRNGKey(0)
    if entry == "kernel":
        sp = cfg.ffn_sparsity
        params = jax.eval_shape(lambda: packed_linear_init(
            key, cfg.d_ff, cfg.d_model, sp, bias=False)[0])

        def fn(p, x):
            with jax.named_scope("ffn_kwta"):
                h, support = apply_kwta(x, sp, return_support=True)
            with jax.named_scope("ffn_down"):
                return packed_linear_apply(
                    p, h, sp, x_is_sparse=sp.activation_sparse,
                    support=support)
        return jax.make_jaxpr(fn)(params, _sds((SLOTS, cfg.d_ff),
                                               jnp.float32))
    params = jax.eval_shape(lambda: T.init_model(key, cfg)[0])
    batch = {"tokens": _sds((SLOTS, 1), jnp.int32)}
    pos = _sds((SLOTS,), jnp.int32)
    if entry == "decode":
        cache = jax.eval_shape(lambda: T.init_cache(cfg, SLOTS, MAX_SEQ)[0])
        return jax.make_jaxpr(lambda p, c, b, q: T.serve_step(
            p, c, b, q, cfg))(params, cache, batch, pos)
    if entry == "decode_paged":
        geo = PagedKV.build(MAX_SEQ, SLOTS, page_size=16)
        cache = jax.eval_shape(lambda: T.init_paged_cache(
            cfg, geo.n_pages, geo.page_size)[0])
        pages = _sds((SLOTS, geo.blocks_per_slot), jnp.int32)
        return jax.make_jaxpr(lambda p, c, b, q, pg: T.serve_step(
            p, c, b, q, cfg, pages=pg))(params, cache, batch, pos, pages)
    return jax.make_jaxpr(lambda p, b: T.prefill(p, b, cfg, MAX_SEQ))(
        params, {"tokens": _sds((1, SEQ), jnp.int32)})


def _reference_counts(closed):
    counts = collections.Counter()
    for eqn, path, _ in j_walk.iter_eqns(closed, into_pallas=False):
        if eqn.primitive.name in j_rules.SELECT_PRIMS:
            counts[j_rules.layer_key(path)] += 1
    return dict(counts)


def _port_graph(cfg, entry):
    fn, args = t_lint.entry_args(cfg, entry, "cpu", SLOTS, SEQ, MAX_SEQ)
    return trace(fn, *args)


@pytest.mark.parametrize("use_pallas", ["force", "off"])
@pytest.mark.parametrize("arch", CONFIGS)
def test_select_counts_equal_the_reference_jaxprs(arch, use_pallas):
    """Every unit of the port's traced decode, paged decode, prefill and
    kernel entries stages, layer by layer, the Selects the reference's
    jaxpr stages in its one scan body (reduced configs)."""
    tcfg = t_lint.resolve_config(arch, use_pallas, reduced=True)
    jcfg = j_lint._with_pallas_mode(j_get_config(arch).reduced(), use_pallas)
    for entry in ("decode", "decode_paged", "prefill", "kernel"):
        want = _reference_counts(_reference_jaxpr(jcfg, entry))
        by_unit = collections.defaultdict(dict)
        for (unit, key), n in select_counts(_port_graph(tcfg, entry)).items():
            by_unit[unit][key] = n
        if entry == "kernel":
            assert dict(by_unit) == ({"": want} if want else {}), entry
        else:
            units = {f"u{u}" for u in range(tcfg.n_units)}
            assert set(by_unit) <= units, (entry, dict(by_unit))
            for u in units:
                assert by_unit.get(u, {}) == want, (entry, u, want)
        assert sum(want.values()) > 0 or entry == "prefill", (entry, want)


# ---------------------------------------------------------------------------
# Taint and dense-fallback
# ---------------------------------------------------------------------------

def test_taint_flags_a_product_on_the_select_support():
    def bad(x, w):
        vals, _ = torch.topk(x, 4)
        return vals @ w

    gm = trace(bad, torch.zeros(2, 8), torch.zeros(4, 3))
    hits = propagate_taint(gm, ("aten.topk",), t_rules.KERNEL_OPS,
                           t_rules.DENSE_OPS)
    assert [op_name(n) for n, _ in hits] == ["aten.mm"]


def test_taint_stops_at_the_kernel_and_clean_inputs_pass():
    from repro_torch.kernels import topk_gather

    def clean(x, w):
        torch.topk(x, 4)                  # support derived, never consumed
        return x @ w

    gm = trace(clean, torch.zeros(2, 8), torch.zeros(8, 3))
    assert propagate_taint(gm, ("aten.topk",), t_rules.KERNEL_OPS,
                           t_rules.DENSE_OPS) == []

    def sunk(x, packed_p, route, w):
        vals, idx = torch.topk(x.abs(), 4)
        y = topk_gather(vals, idx // 4, idx % 4, packed_p, route)
        return y @ w                      # the kernel's output is clean

    gm = trace(sunk, torch.zeros(2, 32), torch.zeros(8, 3, 4),
               torch.zeros(1, 8, 4, dtype=torch.int8), torch.zeros(12, 5))
    assert propagate_taint(gm, ("aten.topk",), t_rules.KERNEL_OPS,
                           t_rules.DENSE_OPS) == []


def _reference_double_topk_jaxpr():
    """The reference's double-topk regression (``lint.py:704``), staged."""
    from repro.core.layers import (apply_kwta, packed_linear_apply,
                                   packed_linear_init)
    sp = JSparsityConfig(n=4, k_frac=0.125, route_share=0, kwta_impl="topk")
    params = jax.eval_shape(lambda: packed_linear_init(
        jax.random.PRNGKey(0), 128, 64, sp, bias=False)[0])

    def bad(p, x):
        with jax.named_scope("b0_attn"):
            with jax.named_scope("ffn_kwta"):
                h, _ = apply_kwta(x, sp, return_support=True)
            with jax.named_scope("ffn_down"):
                return packed_linear_apply(p, h, sp, x_is_sparse=True,
                                           support=None)
    return jax.make_jaxpr(bad)(params, _sds((2, 128), jnp.float32))


def test_dense_fallback_flags_both_double_topk_regressions():
    """The reference's rule flags its regression (its ``auto`` runs the
    jnp formula off a TPU); the port's flags the port's (the formula,
    ``use_pallas="off"``), at the down projection in both."""
    j_hits = j_rules.rule_dense_fallback(_reference_double_topk_jaxpr())
    assert j_hits and all(f.rule == "dense-fallback" for f in j_hits)
    assert any("ffn_down" in f.scope for f in j_hits)
    report = seeded_regressions()["double-topk"]("cpu")
    assert report.by_rule("select-count")
    hits = report.by_rule("dense-fallback")
    assert hits and all("b0_attn/ffn_down" in f.scope for f in hits)


def test_decode_with_the_kernel_is_clean_in_both_packages():
    jcfg = j_lint._with_pallas_mode(j_get_config("smollm_360m").reduced(),
                                    "force")
    assert j_rules.rule_dense_fallback(_reference_jaxpr(jcfg,
                                                        "decode")) == []
    report = lint_config("smollm-360m", entries=("decode",), reduced=True,
                         device="cpu")
    assert report.ok, report.render()
    # the rule ran: the decode step is on the kernel's topk path
    assert t_lint._wants_dense_fallback_rule(
        t_lint.resolve_config("smollm-360m", reduced=True), SLOTS)


# ---------------------------------------------------------------------------
# dtype, launch-resource and host-transfer rules on small graphs
# ---------------------------------------------------------------------------

def test_f64_regression_names_the_scope_and_the_type():
    report = seeded_regressions()["f64-kernel"]("cpu")
    found = report.by_rule("dtype-promotion")
    assert found, report.render()
    assert any("ffn_down" in f.scope for f in found)
    assert any("float64" in f.message for f in found)


def test_a_kernel_operand_of_an_undeclared_type_is_flagged():
    from torch.fx.experimental.proxy_tensor import make_fx

    def call(x, k):
        return torch.ops.repro_torch.kwta_hist(x, k)

    gm = make_fx(lambda x: call(x, 4), tracing_mode="fake")(
        torch.zeros(2, 8, dtype=torch.float16))
    found = t_rules.rule_dtype_promotion(gm)
    assert found and "float16" in found[0].message


def test_launch_resource_limits():
    from repro_torch.kernels.build import Geometry
    assert t_rules.check_geometry("k", Geometry((4, 1, 1), 256)) == []
    over = t_rules.check_geometry("k", Geometry((3, 70000, 1), 2048, 16,
                                               16 << 20))
    text = " ".join(f.message for f in over)
    assert len(over) == 5 and all(f.rule == "launch-resource" for f in over)
    for needle in ("2048 threads", "dynamic shared memory", "clusters of 16",
                   "grid axis 1", "multiple of the cluster"):
        assert needle in text
    # the shipped launchers at the model's widest shapes fit the card
    gm = _port_graph(t_lint.resolve_config("starcoder2-15b"), "kernel")
    assert t_rules.rule_launch_resource(gm) == []


@pytest.mark.parametrize("case", ["item", "nonzero", "masked_select",
                                  "bool", "numpy"])
def test_host_transfers_are_findings_not_crashes(case):
    """An op whose result the host must see is a finding; so is a trace
    that stops because the code asked for a value."""
    fns = {"item": lambda x: x * x.sum().item(),
           "nonzero": lambda x: x.nonzero().float().sum() + x,
           "masked_select": lambda x: x.masked_select(x > 0).sum() + x,
           "bool": lambda x: x + (1 if bool(x.sum() > 0) else 2),
           "numpy": lambda x: x + float(x.numpy().sum())}
    report = lint_fn(fns[case], torch.zeros(4), check_host=True,
                     check_select=False)
    found = report.by_rule("host-transfer")
    assert found, report.render()
    if case in ("bool", "numpy"):
        assert "the trace stopped" in found[0].message


def test_the_ported_permute_keeps_a_device_route_on_the_device():
    """The fault this linter found in the port: ``permute_activations``
    took ``route_shared.cpu().numpy()`` on every call, a host round trip
    for a route on the card.  Traced on fake tensors the old code stops
    at ``.numpy()``; the repaired one traces with no host transfer."""
    import numpy as np_

    from repro_torch.kernels import permute_activations

    def old(x, route):
        r = np_.asarray(route.cpu().numpy()).reshape(route.shape[-2:])
        idx = torch.from_numpy(np_.arange(r.shape[0])[:, None] * r.shape[1]
                               + r.astype(np_.int64))
        return x[..., idx].movedim(-1, 0)

    x, route = torch.zeros(2, 16), torch.zeros(1, 4, 4, dtype=torch.int8)
    bad = lint_fn(old, x, route, check_host=True, check_select=False)
    assert bad.by_rule("host-transfer"), bad.render()
    good = lint_fn(permute_activations, x, route, check_host=True,
                   check_select=False)
    assert good.ok, good.render()


def test_rule_host_transfer_flags_a_device_to_host_copy():
    from repro_torch.analysis.graph_walk import iter_nodes
    gm = trace(lambda x: x.sum().item() + 0, torch.zeros(3))
    found = rule_host_transfer(gm, "decode")
    assert [f.primitive for f in found] == ["aten._local_scalar_dense"]
    assert any(op_name(n) == "aten._local_scalar_dense"
               for n, _ in iter_nodes(gm))


# ---------------------------------------------------------------------------
# Waivers and the CLI
# ---------------------------------------------------------------------------

def test_waivers_by_rule_and_scope():
    f1 = Finding(rule="select-count", message="m", scope="u0/b0_attn/ffn")
    f2 = Finding(rule="dense-fallback", message="m", scope="u1/b1_attn/ffn")
    r = Report()
    r.add([f1, f2], waivers=("select-count:u0/b0_attn",))
    assert [f.rule for f in r.findings] == ["dense-fallback"]
    assert r.waived == [f1] and not r.ok


def test_cli_self_test_on_the_cpu_exits_zero(capsys):
    assert cli_main(["--self-test", "--device", "cpu"]) == 0
    assert "all seeded regressions caught" in capsys.readouterr().out


@pytest.mark.parametrize("name,rule,needles", [
    ("oob-gather", "oob-access", ("_oob_gather_kernel", "in[2]")),
    ("missing-init", "grid-race", ("_missing_init_kernel", "out[2]")),
    ("double-topk", "select-count", ("b0_attn/ffn", "topk")),
    ("f64-kernel", "dtype-promotion", ("float64",))])
def test_cli_seeded_regressions_exit_one(capsys, name, rule, needles):
    assert cli_main(["--seed-regression", name, "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert rule in out and all(n in out for n in needles)


def test_cli_usage_errors_exit_two(capsys):
    assert cli_main([]) == 2
    with pytest.raises(SystemExit) as e:
        cli_main(["--seed-regression", "no-such"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        cli_main(["--config", "smollm-360m", "--device", "tpu"])
    assert e.value.code == 2


def test_cli_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--self-test"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_lint.self_test()


def test_cli_reduced_config_and_kernels_exit_zero(capsys):
    rc = cli_main(["--config", "smollm-360m", "--reduced", "--kernels",
                   "--device", "cpu", "--json"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert '"findings": []' in out and "kernels:topk_gather" in out


def test_train_entry_and_unported_configs_raise():
    """The configs ``check_supported`` rejects raise on every entry, the
    training loss's too (the train entry itself is ported: next test)."""
    for entries in (t_lint.PORTED_ENTRIES, ("train",)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lint_config("zamba2-1.2b", entries=entries, reduced=True,
                        device="cpu")


@pytest.mark.parametrize("kwta_impl", ["bisect", "topk"])
def test_train_entry_lints_clean(kwta_impl):
    """The reference's train entry (``lint.py:298-305``): the forward of
    ``loss_fn`` over two sequences, the Select count of
    ``expected_selects(cfg, n_tokens=2·seq)``, no dense-fallback rule:
    0 findings on smollm reduced, with the shipped ``bisect`` k-WTA (0
    Selects a layer) and with exact top-k (1 a layer)."""
    cfg = t_get_config("smollm-360m").reduced()
    cfg = dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
        cfg.ffn_sparsity, kwta_impl=kwta_impl))
    report = lint_config(cfg, entries=("train",), device="cpu")
    assert report.entries == ["train"]
    assert report.findings == [], report.render()
    want = 0 if kwta_impl == "bisect" else 1
    assert set(t_lint.expected_selects(cfg, 16).values()) == {want}


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_moe_configs_lint_clean(arch):
    """The MLA/MoE family lints clean on every ported entry.  As in the
    reference, MoE configs skip the select-count and dense-fallback rules
    (the router runs its own top-k); the host-transfer rule holds the
    decode steps, whose capacity dispatch must not sync."""
    report = lint_config(arch, reduced=True, device="cpu")
    assert report.findings == [], report.findings
    assert sorted(report.entries) == sorted(t_lint.PORTED_ENTRIES)
