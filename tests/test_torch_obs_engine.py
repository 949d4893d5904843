"""The port's serving telemetry against the reference's, engine to engine:
``Engine(telemetry=Telemetry.on(jsonl))`` of both packages on the same
bridged weights (reduced smollm-360m, float32) and the same requests, on
the contiguous layout with the exact top-k FFN (winner supports: the
overlap path) and with the shipped bisect FFN (the nnz path), and the
paged layout with the bisect FFN.

Equal: the tokens, every counter, each histogram's count, the span names
and counts of ``tracer.totals()``, the dispatch sites (path, batch, d_in,
d_out, n, k; the reference's scan body counts one unit, the port's loop
every layer, so the port's sites are the reference's once a unit), the
gauge names, the sparsity layer keys and ``probe_steps``.  Within 1e-6:
``realized_k_frac`` and ``winner_overlap`` per layer (winner sets compare
as sets, so tied top-k orders do not matter).  The port's JSONL passes
the reference's ``validate_jsonl``.

Then: telemetry never changes the tokens."""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import SparsityConfig as JSparsity
from repro.launch.mesh import make_mesh
from repro.launch.serve import Engine as JEngine
from repro.obs import Telemetry as JTelemetry
from repro.obs.export import validate_jsonl as j_validate_jsonl
from repro.runtime.scheduler import Request as JRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import SparsityConfig
from repro_torch.launch.serve import Engine
from repro_torch.obs import Telemetry
from repro_torch.obs.export import validate_jsonl
from repro_torch.runtime.scheduler import Request

BASE = dict(head_pad=0, compute_dtype="float32", param_dtype="float32")
# the exact top-k sparse-sparse FFN, and the shipped bisect FFN (reduced
# keeps it at n=4, route_share=0)
FFN = {"topk": dict(n=4, k_frac=0.125), "bisect": None}
MAX_SEQ, N_SLOTS = 48, 4
# the paged layout: pages of 8, a 13-page pool, chunks of 8
PAGED = dict(kv_layout="paged", page_size=8, n_pages=13, prefill_chunk=8)
# probe every step on the contiguous layout, every other on the paged one
PROBE_EVERY = {"contiguous": 1, "paged": 2}
SITE_KEYS = ("path", "batch", "d_in", "d_out", "n", "k")


def _configs(ffn):
    sp = FFN[ffn]
    jcfg = jget_config("smollm-360m").reduced(
        **BASE, **({"ffn_sparsity": JSparsity(**sp)} if sp else {}))
    cfg = get_config("smollm-360m").reduced(
        **BASE, **({"ffn_sparsity": SparsityConfig(**sp)} if sp else {}))
    return jcfg, cfg


def _workload(vocab):
    """Mixed lengths and budgets (slots refill, two prefill buckets), and
    on the paged pool a parent, its exact duplicate and an extension of
    it (prefix pages adopted, a copy-on-write break), with budgets that
    make the 12 usable pages run dry (preemption)."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, vocab, 12).tolist()
    fillers = [(rng.integers(0, vocab, 3).tolist(), 1) for _ in range(3)]
    return ([(base, 30)] + fillers + [
        (base, 30), (base + rng.integers(0, vocab, 9).tolist(), 14),
        (rng.integers(0, vocab, 20).tolist(), 20),
        (rng.integers(0, vocab, 9).tolist(), 6)])


# the exact top-k FFN (overlap path) on the contiguous layout, the shipped
# bisect FFN (nnz path) on both
CONFIGS = [("contiguous", "topk"), ("contiguous", "bisect"),
           ("paged", "bisect")]


@pytest.fixture(scope="module", params=CONFIGS,
                ids=lambda p: f"{p[0]}-{p[1]}")
def served(request, tmp_path_factory):
    """Both engines served with telemetry on: (layout, ffn, reference
    engine, its outputs and JSONL, port engine, its outputs and JSONL)."""
    layout, ffn = request.param
    tmp = tmp_path_factory.mktemp(f"{layout}-{ffn}")
    jcfg, cfg = _configs(ffn)
    kw = PAGED if layout == "paged" else {}
    every = PROBE_EVERY[layout]
    spec = _workload(cfg.vocab_size)
    jtel = JTelemetry.on(jsonl_path=str(tmp / "ref.jsonl"),
                         sparsity_every=every)
    jeng = JEngine(jcfg, make_mesh((1, 1), ("data", "model")),
                   max_seq=MAX_SEQ, n_slots=N_SLOTS, telemetry=jtel, **kw)
    jout, jstats = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=g)
                               for i, (p, g) in enumerate(spec)])
    jtel.close()
    jsnap = jeng.metrics_snapshot()
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg,
                             device="cpu")
    tel = Telemetry.on(jsonl_path=str(tmp / "port.jsonl"),
                       sparsity_every=every)
    eng = Engine(cfg, max_seq=MAX_SEQ, n_slots=N_SLOTS, params=params,
                 device="cpu", telemetry=tel, **kw)
    out, stats = eng.serve([Request(uid=i, prompt=p, max_new_tokens=g)
                            for i, (p, g) in enumerate(spec)])
    tel.close()
    return dict(layout=layout, ffn=ffn, jeng=jeng, jout=jout,
                jstats=jstats, jpath=tmp / "ref.jsonl", jsnap=jsnap, eng=eng,
                out=out, stats=stats, path=tmp / "port.jsonl",
                snap=eng.metrics_snapshot(), params=params, cfg=cfg,
                spec=spec)


def test_tokens_and_registry_equal_the_reference(served):
    s = served
    assert s["out"] == {u: [int(t) for t in v] for u, v in s["jout"].items()}
    snap, jsnap = s["snap"], s["jsnap"]
    m, jm = snap["metrics"], jsnap["metrics"]
    assert m["counters"] == jm["counters"]
    assert set(m["histograms"]) == set(jm["histograms"])
    for name, h in m["histograms"].items():
        if name.endswith("_recent_s"):
            # windowed on the real clock (60 s): what a slow run observed
            # early may have aged out by the snapshot
            twin = name.replace("_recent_s", "_s")
            assert h["count"] <= m["histograms"][twin]["count"]
            assert jm["histograms"][name]["count"] <= \
                jm["histograms"][twin]["count"]
        else:
            assert h["count"] == jm["histograms"][name]["count"], name
    assert set(m["gauges"]) == set(jm["gauges"])
    for name in ("serve.queue_depth", "serve.slots_active",
                 "serve.slot_occupancy", "serve.pages_used",
                 "serve.pages_free", "serve.page_occupancy"):
        assert m["gauges"][name] == jm["gauges"][name], name
    assert set(snap["requests"]) == set(jsnap["requests"])
    for uid, ev in snap["requests"].items():
        for key in ("status", "n_tokens", "preemptions"):
            assert ev[key] == jsnap["requests"][uid][key], (uid, key)
    if s["layout"] == "paged":
        c = m["counters"]
        assert c["serve.preemptions"] >= 1 and c["serve.cow_copies"] >= 1
        assert c["serve.prefix_hit_pages"] >= 1
        assert c["serve.kv_grow_pages"] >= 1


def test_spans_equal_the_reference(served):
    s = served
    stages, jstages = s["snap"]["stages"], s["jsnap"]["stages"]
    assert {k: v["count"] for k, v in stages.items()} == \
        {k: v["count"] for k, v in jstages.items()}
    want = ({"schedule.admit", "prefill.chunk", "kv.cow", "sample",
             "decode.step"} if s["layout"] == "paged" else
            {"schedule.admit", "prefill", "insert", "sample", "decode.step"})
    assert set(stages) == want
    probed = [e.attrs["probed"] for e in s["eng"].telemetry.tracer.events
              if e.name == "decode.step"]
    jprobed = [e.attrs["probed"] for e in s["jeng"].telemetry.tracer.events
               if e.name == "decode.step"]
    assert probed == jprobed and any(probed)
    assert (not all(probed)) == (PROBE_EVERY[s["layout"]] > 1)


def test_dispatch_sites_equal_the_reference_once_a_unit(served):
    s = served
    cfg = s["cfg"]
    n_units = cfg.n_layers // len(cfg.block_pattern)
    sites = [tuple(ev[k] for k in SITE_KEYS)
             for ev in s["eng"]._dispatch.sites]
    jsites = [tuple(ev[k] for k in SITE_KEYS)
              for ev in s["jeng"]._dispatch.sites]
    assert jsites and sites == jsites * n_units
    assert s["eng"]._dispatch.sealed
    assert {ev["backend"] for ev in s["eng"]._dispatch.sites} == {"torch"}
    paths = s["snap"]["sparsity"]["paths"]
    jpaths = s["jsnap"]["sparsity"]["paths"]
    assert paths["sparse_flop_frac_est"] == jpaths["sparse_flop_frac_est"]
    assert {k.split("[")[0]: v["sites"] for k, v in paths["paths"].items()} \
        == {k.split("[")[0]: n_units * v["sites"]
            for k, v in jpaths["paths"].items()}


def test_realized_sparsity_equals_the_reference(served):
    s = served
    sp, jsp = s["snap"]["sparsity"], s["jsnap"]["sparsity"]
    assert sp["probe_steps"] == jsp["probe_steps"] > 0
    assert set(sp["layers"]) == set(jsp["layers"])
    cfg = s["cfg"]
    assert len(sp["layers"]) == cfg.n_layers
    overlap = 0
    for name, e in sp["layers"].items():
        je = jsp["layers"][name]
        assert {k: v for k, v in e.items()
                if k not in ("realized_k_frac", "winner_overlap")} == \
            {k: v for k, v in je.items()
             if k not in ("realized_k_frac", "winner_overlap")}, name
        assert abs(e["realized_k_frac"] - je["realized_k_frac"]) <= 1e-6
        assert ("winner_overlap" in e) == ("winner_overlap" in je)
        if "winner_overlap" in e:
            overlap += 1
            assert abs(e["winner_overlap"] - je["winner_overlap"]) <= 1e-6
        k = cfg.ffn_sparsity.k_for(cfg.d_ff)
        assert k / cfg.d_ff - 1e-9 <= e["realized_k_frac"] <= 1.0
    # the exact top-k FFN hands supports over (overlap); bisect has none
    assert (overlap > 0) == (s["ffn"] == "topk")


def test_jsonl_passes_both_validators(served):
    s = served
    for validate in (validate_jsonl, j_validate_jsonl):
        n, errors = validate(str(s["path"]))
        assert errors == [] and n > 0
    kinds = [line.split('"kind": "')[1].split('"')[0]
             for line in open(s["path"])]
    jkinds = [line.split('"kind": "')[1].split('"')[0]
              for line in open(s["jpath"])]
    assert set(kinds) == {"span", "request", "snapshot"}
    assert sorted(kinds) == sorted(jkinds)


def test_telemetry_does_not_change_the_tokens(served):
    """Off and on but never probed give the tokens of the probed run
    above, and with telemetry off the engine records nothing."""
    s = served
    kw = PAGED if s["layout"] == "paged" else {}
    reqs = [Request(uid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(s["spec"])]
    for tel in (None, Telemetry.on(sparsity_every=0)):
        eng = Engine(s["cfg"], max_seq=MAX_SEQ, n_slots=N_SLOTS,
                     params=s["params"], device="cpu", telemetry=tel, **kw)
        out, _ = eng.serve(reqs)
        assert out == s["out"]
        snap = eng.metrics_snapshot()
        if tel is None:
            assert snap["metrics"] == {"counters": {}, "gauges": {},
                                       "histograms": {}}
            assert snap["stages"] == {} and not snap["sparsity"]["layers"]
            assert not eng._dispatch.sites
        else:
            assert snap["sparsity"]["probe_steps"] == 0
            assert snap["metrics"]["counters"]["serve.decode_steps"] > 0
