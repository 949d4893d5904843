"""The census of a traced call (``repro_torch.launch.hlo``) against the
reference's HLO accounting (``repro.launch.hlo``) on the CPU: collectives
of a step on a fake 2x2 process group, host transfers, product FLOPs
against ``core.functional.flops_*`` and XLA's ``compiled_flops``, the
paper's FLOP-saving checks through the port's counter with the
reference's thresholds, the four kernel ops' cost formulas against their
plain versions, and an op without a formula.

Product FLOPs are exact (2·M·N·K a dot, as XLA counts them); the
FLOP-saving checks keep the reference's thresholds."""

import collections

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.launch.hlo import compiled_flops
from repro.models import gsc_cnn as JG
from repro_torch.configs import get_config
from repro_torch.core import SparsityConfig
from repro_torch.core import functional as F
from repro_torch.core.layers import packed_linear_init
from repro_torch.kernels import (grouped_cs_matmul, grouped_cs_matmul_plain,
                                 kwta_hist_cuda, kwta_hist_cuda_plain,
                                 packed_matmul, packed_matmul_plain,
                                 topk_gather, topk_gather_plain)
from repro_torch.kernels import build, registry
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.hlo import (COLLECTIVE_KINDS, HOST_OPS, census,
                                    counted_flops)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import gsc_cnn as G
from repro_torch.models import transformer as T
from repro_torch.sharding.collectives import observe_collectives
from repro_torch.sharding.serving import Shards, use_serving


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _decode_args(cfg, slots=4, max_seq=32, rules=None):
    params = T.init_model(cfg, seed=0, device="cpu", rules=rules)
    cache = T.init_cache(cfg, slots, max_seq, "cpu", rules=rules)
    batch = {"tokens": torch.zeros((slots, 1), dtype=torch.int64)}
    return params, cache, batch, torch.full((slots,), 5)


def _step(cfg):
    return lambda p, c, b, q: T.serve_step(p, c, b, q, cfg)[0]


# (a) collectives -----------------------------------------------------------

def test_collectives_of_a_2x2_step_are_what_the_observer_saw():
    cfg = get_config("smollm-360m").reduced()
    seen = []
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        shards = Shards.of(mesh, 32)
        args = _decode_args(cfg, rules=shards.rules)
        with use_serving(shards), observe_collectives(
                lambda op, ts: seen.append((op, ts[-1].numel()
                                            * ts[-1].element_size()))):
            rec = census(_step(cfg), *args)
    coll = rec["collectives"]
    want = collections.defaultdict(float)
    for op, nbytes in seen:
        want[f"{COLLECTIVE_KINDS[op]}_bytes"] += nbytes
        want[f"{COLLECTIVE_KINDS[op]}_count"] += 1
    assert {k for k in coll if k != "total_bytes"} == set(want)
    assert {"all-gather_count", "all-reduce_count"} <= set(want)
    for k, v in want.items():
        assert coll[k] == v, k
    assert coll["total_bytes"] == sum(b for _, b in seen) > 0
    # the c10d calls are not ops: the decode step's ops are the same as on
    # one rank's blocks without a process group to talk to
    assert rec["ops"]["kernels"] == cfg.n_layers


def test_a_step_without_a_process_group_has_no_collective():
    cfg = get_config("smollm-360m").reduced()
    rec = census(_step(cfg), *_decode_args(cfg))
    assert rec["collectives"] == {"total_bytes": 0.0}


# (b) host transfers ----------------------------------------------------------

def test_host_transfers_are_found():
    t = torch.arange(10.0)
    assert census(lambda t: t.sum().item(), t)["host_transfers"] == [
        "aten._local_scalar_dense"]
    assert census(lambda t: t.nonzero(), t)["host_transfers"] == [
        "aten.nonzero"]
    with FakeTensorMode():
        on_card = torch.empty(4, device="cuda")
    assert census(lambda t: t.cpu(), on_card)["host_transfers"] == [
        "aten._to_copy"]
    assert set(HOST_OPS) >= {"aten._local_scalar_dense", "aten.nonzero"}


def test_the_contiguous_decode_step_has_no_host_transfer():
    cfg = get_config("smollm-360m").reduced()
    rec = census(_step(cfg), *_decode_args(cfg))
    assert rec["host_transfers"] == []
    assert rec["ops"]["repro_torch.topk_gather"] == cfg.n_layers


# (c) products exactly --------------------------------------------------------

B, D_IN, D_OUT, N = 64, 512, 512, 8


@pytest.fixture(scope="module")
def cs_case():
    gen = torch.Generator().manual_seed(0)
    layer = packed_linear_init(gen, D_IN, D_OUT,
                               SparsityConfig(n=N, route_share=D_OUT // N),
                               bias=False, seed=0)
    x = torch.randn(B, D_IN, generator=gen)
    return x, layer["packed"], layer["route"]


def test_products_equal_the_flops_formulas(cs_case):
    x, packed, route = cs_case
    w = F.decompress(packed, route)
    cases = {
        "dense": (lambda x: x @ w, F.flops_dense(B, D_IN, D_OUT)),
        "cs_matmul": (lambda x: F.cs_matmul(x, packed, route),
                      F.flops_cs_matmul(B, D_IN, D_OUT, N)),
        "cs_matmul_dense": (lambda x: F.cs_matmul_dense(x, packed, route),
                            F.flops_dense(B, D_IN, D_OUT)),
        "cs_topk_matmul": (lambda x: F.cs_topk_matmul(x, packed, route, 32),
                           F.flops_cs_topk(B, 32, D_OUT)),
    }
    for name, (fn, want) in cases.items():
        rec = census(fn, x)
        assert rec["cost"]["product_flops"] == want, name
        with FlopCounterMode(display=False) as fc:
            fn(x)
        assert fc.get_total_flops() == want, name


def test_pure_products_equal_the_reference_compiled_flops():
    x = torch.zeros(B, D_IN)
    w = torch.zeros(D_IN, D_OUT)
    jx = jax.ShapeDtypeStruct((B, D_IN), jnp.float32)
    jw = jnp.zeros((D_IN, D_OUT))
    ref = compiled_flops(jax.jit(lambda x: x @ jw).lower(jx).compile())
    assert counted_flops(lambda x, w: x @ w, x, w) == ref == 2 * B * D_IN \
        * D_OUT
    # the grouped CS product: N independent (B, P) @ (P, G)
    xg, ws = torch.zeros(N, B, D_IN // N), torch.zeros(N, D_IN // N, 16)
    jws = jnp.zeros(tuple(ws.shape))
    ref = compiled_flops(jax.jit(
        lambda xg: jnp.einsum("nbp,npg->nbg", xg, jws)).lower(
        jax.ShapeDtypeStruct(tuple(xg.shape), jnp.float32)).compile())
    assert counted_flops(lambda a, b: torch.einsum("nbp,npg->nbg", a, b),
                         xg, ws) == ref


# (d) the paper's FLOP savings through the port's counter ---------------------

def test_flop_savings_in_the_census(cs_case):
    """The faithful CS product costs ~1/N of dense FLOPs (the reference's
    ``test_flop_savings_in_hlo``, same shapes and threshold)."""
    x, packed, route = cs_case
    w = F.decompress(packed, route)
    fs = counted_flops(lambda x: F.cs_matmul(x, packed, route), x)
    fd = counted_flops(lambda x: x @ w, x)
    assert fs < fd / (N / 2), f"sparse {fs} vs dense {fd}"


def test_gsc_flop_reductions_match_the_paper_structure():
    """The reference's ``test_gsc_e2e.py`` ratios on the port's network:
    dense / sparse-dense > 4, and sparse-sparse no worse than 0.9 of it."""
    flops = {}
    for v in ("dense", "sparse_dense", "sparse_sparse"):
        cfg = G.GSCConfig(variant=v)
        params = G.init_model(cfg, seed=0, device="cpu")
        flops[v] = counted_flops(lambda p, x: G.forward(p, x, cfg), params,
                                 torch.zeros(1, 32, 32, 1))
    rd = flops["dense"] / flops["sparse_dense"]
    rs = flops["dense"] / flops["sparse_sparse"]
    assert rd > 4, f"sparse-dense reduction only {rd:.1f}x"
    assert rs > 0.9 * rd, f"sparse-sparse regressed FLOPs: {rs:.1f}x"
    macs = JG.theoretical_macs(JG.GSCConfig())
    assert macs["speedup_ss"] > 30


# (e) the kernel ops' formulas -----------------------------------------------

def _topk_operands(b, k, p, g, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(b, k, generator=gen),
            torch.randint(0, p, (b, k), generator=gen, dtype=torch.int32),
            torch.randint(0, n, (b, k), generator=gen, dtype=torch.int32),
            torch.randn(p, g, n, generator=gen),
            torch.randint(0, n, (1, p, n), generator=gen, dtype=torch.int8))


def _held(op, wrapper, plain, args):
    """The census of the wrapper (one op node, its formula) against
    FlopCounterMode's products of the plain version; returns both."""
    rec = census(wrapper, *args)
    assert rec["ops"]["kernels"] == 1 and rec["ops"][op] == 1
    with FlopCounterMode(display=False) as fc:
        plain(*args)
    return rec, fc.get_total_flops()


@pytest.mark.parametrize("shape", registry.TOPK_GATHER_SWEEP)
def test_topk_gather_formula_counts_its_plain_products(shape):
    b, k, p, g, n, _ = shape
    args = _topk_operands(b, k, p, g, n)
    rec, plain = _held("repro_torch.topk_gather", topk_gather,
                       topk_gather_plain, args)
    assert rec["cost"]["flops"] == plain == 2 * b * k * g * n
    assert rec["cost"]["flops_f32"] == plain     # CUDA cores
    rows = min(b * k, p)
    assert rec["cost"]["bytes_accessed"] == (b * k * 12 + rows * g * n * 4
                                             + rows * n + b * g * n * 4)


@pytest.mark.parametrize("shape", registry.PACKED_MATMUL_SWEEP)
def test_packed_matmul_formula_counts_its_plain_products(shape):
    b, p, g, n = shape[:4]
    gen = torch.Generator().manual_seed(1)
    args = (torch.randn(b, p * n, generator=gen),
            torch.randn(g, p, n, generator=gen),
            torch.randint(0, n, (1, p, n), generator=gen, dtype=torch.int8))
    rec, plain = _held("repro_torch.packed_matmul", packed_matmul,
                       packed_matmul_plain, args)
    assert rec["cost"]["flops"] == plain == 2 * b * p * n * g
    bf16 = tuple(t.bfloat16() for t in args[:2]) + args[2:]
    assert census(packed_matmul, *bf16)["cost"]["flops_bf16"] == plain


@pytest.mark.parametrize("shape", registry.GROUPED_CS_SWEEP)
def test_grouped_cs_matmul_formula_counts_its_plain_products(shape):
    n, b, p, g = shape[:4]
    gen = torch.Generator().manual_seed(2)
    args = (torch.randn(n, b, p, generator=gen),
            torch.randn(n, p, g, generator=gen))
    rec, plain = _held("repro_torch.grouped_cs_matmul", grouped_cs_matmul,
                       grouped_cs_matmul_plain, args)
    assert rec["cost"]["flops"] == plain == 2 * n * b * p * g
    assert rec["cost"]["bytes_accessed"] == 4 * (n * b * p + n * p * g
                                                 + n * b * g)


@pytest.mark.parametrize("shape", registry.KWTA_HIST_SWEEP)
def test_kwta_hist_formula_counts_its_row_operations(shape):
    """k-WTA has no product: its formula counts the row's float32
    operations (the kernel's 7 an element), and the census of its plain
    version's elementwise ops comes to no fewer."""
    b, d, k, _ = shape
    x = torch.randn(b, d, generator=torch.Generator().manual_seed(3))
    rec, plain = _held("repro_torch.kwta_hist", lambda x: kwta_hist_cuda(
        x, k), lambda x: kwta_hist_cuda_plain(x, k), (x,))
    assert plain == 0
    assert rec["cost"]["flops"] == 7 * b * d
    assert rec["cost"]["bytes_accessed"] == 2 * b * d * 4
    elementwise = census(lambda x: kwta_hist_cuda_plain(x, k), x)
    assert elementwise["cost"]["flops"] >= rec["cost"]["flops"]


# (f) an op without a formula raises -----------------------------------------

_PROBE = torch.library.Library("repro_torch", "FRAGMENT")
_PROBE.define("census_probe(Tensor x) -> Tensor")
_PROBE.impl("census_probe", lambda x: x * 2, "CPU")


def test_a_kernel_op_without_a_cost_formula_raises():
    assert "repro_torch.census_probe" not in build.COSTS
    with pytest.raises(NotImplementedError, match="census_probe"):
        census(torch.ops.repro_torch.census_probe, torch.ones(3))
    assert set(build.COSTS) == {
        "repro_torch.topk_gather", "repro_torch.packed_matmul",
        "repro_torch.grouped_cs_matmul", "repro_torch.kwta_hist"}


def test_memory_tracks_storages_not_tensors():
    x = torch.zeros(1000)

    def fn(x):
        y = x * 2               # 4000 B, freed before the next
        z = y[:10]              # a view: no new storage
        w = (z + 1).clone()     # 40 B + 40 B
        del y
        return w

    mem = census(fn, x)["memory"]
    assert mem["argument_bytes"] == 4000
    assert mem["output_bytes"] == 40
    assert mem["peak_bytes_est"] == 4000 + 4000 + 40 + 40


def test_argument_traffic_counts_each_byte_read_or_written_once():
    table, idx = torch.zeros(100, 8), torch.tensor([3, 7, 3, 9])
    unused = torch.zeros(1000)

    def fn(table, idx, unused):
        rows = table[idx]                   # 4 rows of 32 B gathered
        return rows * 2 + table[idx].sum()  # the same rows again

    mem = census(fn, table, idx, unused)["memory"]
    assert mem["argument_bytes"] == 3200 + 32 + 4000
    assert mem["argument_read_bytes"] == 4 * 32 + 32   # unused reads 0
    assert mem["argument_written_bytes"] == 0

    stacked = torch.zeros(4, 50)            # four layers' blocks, one storage
    assert census(lambda w: w[1] + w[3], stacked)["memory"][
        "argument_read_bytes"] == 2 * 200

    cache, row = torch.zeros(6, 10), torch.ones(2, 10)

    def write(cache, row):
        cache.index_put_((torch.tensor([1, 4]),), row)   # cache not read
        return row.sum()

    mem = census(write, cache, row)["memory"]
    assert mem["argument_written_bytes"] == 80
    assert mem["argument_read_bytes"] == 80


def test_the_io_floor_lies_below_the_eager_bytes_of_a_decode_step():
    from repro_torch.launch.roofline import HBM_BW, cell_roofline
    cfg = get_config("smollm-360m").reduced()
    rec = census(_step(cfg), *_decode_args(cfg))
    mem = rec["memory"]
    out = _step(cfg)(*_decode_args(cfg))
    assert mem["output_bytes"] == out.numel() * out.element_size()
    # the cache's new rows: k and v of every layer, one position a slot
    assert mem["argument_written_bytes"] == (
        cfg.n_layers * 2 * 4 * cfg.n_kv_heads * cfg.head_dim * 2)
    assert 0 < mem["argument_read_bytes"] < mem["argument_bytes"]
    roof = cell_roofline({"ok": True, "kind": "decode", "mesh": "1x1",
                          "full": rec})
    io = (mem["argument_read_bytes"] + mem["argument_written_bytes"]
          + mem["output_bytes"])
    assert roof["io_bytes_per_chip"] == io
    assert roof["io_memory_s"] == io / HBM_BW
    assert io < roof["bytes_per_chip"]
    assert roof["floor_s"] <= roof["bound_s"]
