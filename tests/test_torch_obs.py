"""The port's telemetry layer (``repro_torch.obs``) on its own: the unit
tests of tests/test_obs.py mirrored (metrics, rolling histograms, the
tracer, the JSONL round trip, ``validate_event``, the scheduler's
lifecycle records, ``SparsityStats``, ``DispatchStats`` and the bench
columns), each also feeding the same data to the reference's class and
holding the two snapshots equal — exactly, where the data carry no clock.
The monitor's tests (``StepMonitor``, ``LossGuard``) wait for the port's
training slice.

Also: the capture's one-copy readback on mixed dtypes, the shared memory
a ``topk[cuda]`` site reports, the JSONL validator's CLI, and the decode
step's ``make_fx`` graph (``repro_torch.analysis``): the hooks add nothing
with telemetry off or with the dispatch observer on, and a probed step
adds no Select."""

import json
import threading

import numpy as np
import pytest
import torch

from repro.obs import Telemetry as JTelemetry
from repro.obs.export import latency_columns as j_latency_columns
from repro.obs.export import sparsity_columns as j_sparsity_columns
from repro.obs.export import validate_event as j_validate_event
from repro.obs.metrics import Histogram as JHistogram
from repro.obs.metrics import Registry as JRegistry
from repro.obs.metrics import RollingHistogram as JRollingHistogram
from repro.obs.sparsity import DispatchStats as JDispatchStats
from repro.obs.sparsity import SparsityStats as JSparsityStats
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.scheduler import Scheduler as JScheduler
from repro_torch.analysis import select_counts, trace
from repro_torch.configs import get_config
from repro_torch.core import SparsityConfig
from repro_torch.core.api import observe_dispatch
from repro_torch.launch.serve import Engine
from repro_torch.models import transformer as T
from repro_torch.obs import Telemetry
from repro_torch.obs import sparsity as obs_sparsity
from repro_torch.obs.export import (JsonlWriter, latency_columns,
                                    sparsity_columns, validate_event,
                                    validate_jsonl)
from repro_torch.obs.export import main as export_main
from repro_torch.obs.metrics import (NULL_REGISTRY, Histogram, Registry,
                                     RollingHistogram)
from repro_torch.obs.sparsity import (DispatchStats, SparsityStats,
                                      est_topk_smem)
from repro_torch.obs.trace import Tracer
from repro_torch.runtime.scheduler import Request, Scheduler


# ---------------------------------------------------------------------------
# metrics: counters / gauges / histogram math
# ---------------------------------------------------------------------------

def _counter_gauge(reg):
    c = reg.counter("c")
    c.inc()
    c.inc(2.5)
    g = reg.gauge("g")
    assert g.value is None
    g.set(7)
    g.set(4)
    return c, g


def test_counter_gauge_basics():
    c, g = _counter_gauge(reg := Registry())
    assert c.value == 3.5
    assert g.value == 4.0
    snap = reg.snapshot()
    assert snap["counters"]["c"] == 3.5
    assert snap["gauges"]["g"] == 4.0
    _counter_gauge(jreg := JRegistry())
    assert snap == jreg.snapshot()


HIST_DATA = {"spread": ((1.0, 2.0, 4.0), (0.5, 1.5, 3.0, 8.0)),
             "one_bucket": ((1.0, 2.0), (0.25,) * 5)}


@pytest.mark.parametrize("case", sorted(HIST_DATA))
def test_histogram_bucketing_and_percentiles(case):
    edges, data = HIST_DATA[case]
    h = Histogram("h", "s", threading.Lock(), edges=edges)
    jh = JHistogram("h", "s", threading.Lock(), edges=edges)
    for v in data:
        h.observe(v)
        jh.observe(v)
    s = h.snapshot()
    assert s == jh.snapshot()
    if case == "spread":
        assert s["count"] == 4 and s["min"] == 0.5 and s["max"] == 8.0
        assert s["sum"] == pytest.approx(13.0)
        # target=2 lands at the end of bucket (1, 2] -> exactly the edge
        assert h.percentile(50.0) == pytest.approx(2.0)
        # everything above the last edge is clamped by the observed max
        assert h.percentile(100.0) == pytest.approx(8.0)
    else:
        # all mass in one bucket, min == max -> percentiles are exact
        assert h.percentile(50.0) == pytest.approx(0.25)
        assert h.percentile(99.0) == pytest.approx(0.25)
    for q in (0.0, 10.0, 50.0, 95.0, 99.0, 100.0):
        assert h.percentile(q) == jh.percentile(q)


def test_histogram_empty_and_bad_inputs():
    reg = Registry()
    h = reg.histogram("h")
    assert h.snapshot() == {"count": 0}
    assert h.percentile(50.0) is None
    with pytest.raises(ValueError):
        h.percentile(101.0)
    with pytest.raises(ValueError):
        reg.histogram("bad_edges", edges=(2.0, 1.0))
    assert h.edges == JRegistry().histogram("h").edges


def test_registry_idempotent_and_kind_mismatch():
    reg = Registry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")


def test_registry_reset_keeps_handles():
    snaps = []
    for reg in (Registry(), JRegistry()):
        c = reg.counter("c")
        h = reg.histogram("h")
        c.inc(5)
        h.observe(1.0)
        reg.reset()
        assert c.value == 0.0
        assert h.snapshot() == {"count": 0}
        c.inc()  # the old handle still feeds the registry
        snaps.append(reg.snapshot())
    assert snaps[0]["counters"]["c"] == 1.0
    assert snaps[0] == snaps[1]


def test_disabled_registry_hands_out_shared_null():
    tel = Telemetry.off()
    a = tel.registry.counter("a")
    b = tel.registry.histogram("b")
    assert a is b  # one shared null singleton
    a.inc()
    b.observe(1.0)  # no-ops, no raise
    assert tel.registry.snapshot() == {"counters": {}, "gauges": {},
                                       "histograms": {}}
    assert tel.registry.snapshot() == JTelemetry.off().registry.snapshot()
    assert NULL_REGISTRY.counter("z") is a


# ---------------------------------------------------------------------------
# rolling histogram: windowed percentiles with an injected clock
# ---------------------------------------------------------------------------

class _FakeClock:
    """Injectable monotonic clock the tests drive by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _rolling_pair(**kw):
    clk = _FakeClock()
    return clk, [cls("r", "s", threading.Lock(), clock=clk, **kw)
                 for cls in (RollingHistogram, JRollingHistogram)]


def test_rolling_histogram_window_expiry():
    # window 6 s in 3 slices of 2 s
    clk, (h, jh) = _rolling_pair(edges=(1.0, 2.0, 4.0), window_s=6.0,
                                 n_slices=3)
    for t, v in ((0.0, 0.5), (2.5, 3.0)):
        clk.t = t
        h.observe(v)
        jh.observe(v)
    assert h.count == 2     # both inside the window
    clk.t = 6.1             # epoch 3: slice 0's mass (epoch 0) expired
    assert h.count == 1
    assert h.snapshot()["min"] == pytest.approx(3.0)
    assert h.snapshot() == jh.snapshot()
    clk.t = 9.0             # past everything
    assert h.count == 0
    assert h.snapshot() == {"count": 0, "window_s": 6.0} == jh.snapshot()
    assert h.percentile(95.0) is None


def test_rolling_histogram_merges_live_slices():
    edges = (1.0, 2.0, 4.0)
    clk, (roll, jroll) = _rolling_pair(edges=edges, window_s=6.0,
                                       n_slices=3)
    flat = Histogram("h", "s", threading.Lock(), edges=edges)
    # same observations spread across two live slices must merge to the
    # same percentile estimates the run-lifetime histogram computes
    for t, v in ((0.1, 0.5), (0.2, 1.5), (2.1, 3.0), (2.2, 8.0)):
        clk.t = t
        roll.observe(v)
        jroll.observe(v)
        flat.observe(v)
    for q in (50.0, 95.0, 100.0):
        assert roll.percentile(q) == pytest.approx(flat.percentile(q))
    s = roll.snapshot()
    assert s["count"] == 4 and s["sum"] == pytest.approx(13.0)
    assert s["window_s"] == 6.0
    assert s == jroll.snapshot()


def test_rolling_histogram_ring_reuses_slots():
    clk, (h, jh) = _rolling_pair(edges=(1.0,), window_s=2.0, n_slices=2)
    # epoch 0 and epoch 2 share ring position 0: the stale epoch must be
    # zeroed when the slot is reused, not accumulated into
    for t in (0.0, 2.1):
        clk.t = t
        h.observe(0.5)
        jh.observe(0.5)
    assert h.count == 1 == jh.count


def test_rolling_histogram_validation_and_reset():
    lock = threading.Lock()
    with pytest.raises(ValueError):
        RollingHistogram("bad", "s", lock, edges=(2.0, 1.0))
    with pytest.raises(ValueError):
        RollingHistogram("bad", "s", lock, window_s=0.0)
    with pytest.raises(ValueError):
        RollingHistogram("bad", "s", lock, n_slices=0)
    h = RollingHistogram("r", "s", lock, edges=(1.0,), clock=_FakeClock())
    with pytest.raises(ValueError):
        h.percentile(-1.0)
    h.observe(0.5)
    h.reset()
    assert h.count == 0


def test_rolling_histogram_registry_accessor():
    snaps = []
    for reg in (Registry(), JRegistry()):
        clk = _FakeClock()
        h = reg.rolling_histogram("w", window_s=10.0, n_slices=2, clock=clk)
        assert reg.rolling_histogram("w") is h  # idempotent per name
        with pytest.raises(TypeError):
            reg.histogram("w")  # kind mismatch with the plain histogram
        h.observe(0.01)
        snaps.append(reg.snapshot())
        reg.reset()
        assert reg.snapshot()["histograms"]["w"] == {"count": 0,
                                                     "window_s": 10.0}
    snap = snaps[0]["histograms"]["w"]
    assert snap["count"] == 1 and snap["window_s"] == 10.0
    assert snaps[0] == snaps[1]
    # the disabled registry hands the shared null out here too
    assert NULL_REGISTRY.rolling_histogram("w").snapshot() is None


# ---------------------------------------------------------------------------
# tracer: nesting, totals, JSONL schema
# ---------------------------------------------------------------------------

def test_tracer_nesting_and_totals():
    tr = Tracer(enabled=True)
    with tr.span("outer"):
        with tr.span("inner", uid=3):
            pass
        with tr.span("inner"):
            pass
    evs = list(tr.events)
    assert [e.name for e in evs] == ["inner", "inner", "outer"]
    assert evs[0].depth == 1 and evs[0].parent == "outer"
    assert evs[0].attrs == {"uid": 3}
    assert evs[2].depth == 0 and evs[2].parent is None
    tot = tr.totals()
    assert tot["inner"]["count"] == 2 and tot["outer"]["count"] == 1
    assert tot["outer"]["total_s"] >= tot["inner"]["total_s"]
    for ev in evs:
        d = ev.to_dict()
        assert validate_event(d) == [] == j_validate_event(d)


def test_disabled_tracer_is_noop():
    tr = Tracer(enabled=False)
    with tr.span("a"):
        pass
    assert not tr.events and tr.totals() == {}
    # shared null span: no per-call allocation
    assert tr.span("a") is tr.span("b")


def test_tracer_jsonl_roundtrip(tmp_path):
    from repro.obs.export import validate_jsonl as j_validate_jsonl
    path = str(tmp_path / "t.jsonl")
    with JsonlWriter(path) as sink:
        tr = Tracer(enabled=True, sink=sink)
        with tr.span("outer"):
            with tr.span("inner", probed=True):
                pass
    n, errors = validate_jsonl(path)
    assert n == 2 and errors == []
    assert j_validate_jsonl(path) == (2, [])
    lines = [json.loads(x) for x in open(path)]
    assert lines[0]["name"] == "inner" and lines[0]["parent"] == "outer"
    assert lines[0]["attrs"] == {"probed": True}


MALFORMED = [{"kind": "mystery"},
             {"kind": "span", "name": "x"},                  # missing keys
             {"kind": "span", "name": "x", "ts": 0.0, "dur_s": -1.0,
              "depth": 0, "parent": None},
             {"kind": "span", "name": "x", "ts": 0.0, "dur_s": 0.1,
              "depth": True, "parent": None},                 # bool is no int
             {"kind": "request", "uid": 1},
             {"kind": "snapshot", "metrics": []},
             "not an object"]


def test_validate_event_rejects_malformed():
    for ev in MALFORMED:
        assert validate_event(ev), ev
        assert validate_event(ev) == j_validate_event(ev)
    good = {"kind": "span", "name": "x", "ts": 0.0, "dur_s": 0.1,
            "depth": 0, "parent": None}
    assert not validate_event(good) and not j_validate_event(good)


def test_export_cli_validates(tmp_path, capsys):
    good, bad = tmp_path / "good.jsonl", tmp_path / "bad.jsonl"
    good.write_text(json.dumps({"kind": "snapshot", "metrics": {}}) + "\n")
    bad.write_text('{"kind": "span"}\nnot json\n')
    assert export_main(["--validate", str(good)]) == 0
    assert "1 events, schema OK" in capsys.readouterr().out
    assert export_main(["--validate", str(bad)]) == 1
    assert export_main(["--validate", str(good), "--min-events", "2"]) == 1
    assert export_main(["--validate", str(tmp_path / "none.jsonl")]) == 2


# ---------------------------------------------------------------------------
# scheduler lifecycle records (pure policy)
# ---------------------------------------------------------------------------

def _lifecycle(tel, sched_cls, req_cls):
    s = sched_cls(4, telemetry=tel)
    s.submit_many([req_cls(uid=i, prompt=[1, 2, 3], max_new_tokens=3)
                   for i in range(8)], now=0.0)
    t = 0.0
    while s.has_work:
        t += 0.010
        for slot in s.admit(now=t):
            s.record_token(slot, 11, now=t)  # first token from prefill
        s.retire_done(now=t)
        t += 0.005
        for slot in s.active_slots():
            s.record_token(slot, 12, now=t)
        s.retire_done(now=t)
    tel.close()
    return s


def test_scheduler_lifecycle_8_requests_4_slots(tmp_path):
    path = str(tmp_path / "req.jsonl")
    tel = Telemetry.on(jsonl_path=path)
    s = _lifecycle(tel, Scheduler, Request)
    jtel = JTelemetry.on(jsonl_path=str(tmp_path / "jreq.jsonl"))
    js = _lifecycle(jtel, JScheduler, JRequest)
    assert sorted(s.finished) == list(range(8))
    snap = tel.registry.snapshot()
    assert snap["counters"]["serve.requests_submitted"] == 8
    assert snap["counters"]["serve.requests_finished"] == 8
    assert snap["counters"]["serve.tokens_generated"] == 24
    assert snap["histograms"]["serve.ttft_s"]["count"] == 8
    assert snap["histograms"]["serve.itl_s"]["count"] == 16  # 2 itl/req
    # the fed clock is the same: every metric but the windowed ones,
    # which read the real clock to pick their slice, is equal
    jsnap = jtel.registry.snapshot()
    assert snap["counters"] == jsnap["counters"]
    assert snap["gauges"] == jsnap["gauges"]
    assert snap["histograms"]["serve.itl_s"] == \
        jsnap["histograms"]["serve.itl_s"]
    assert set(snap["histograms"]) == set(jsnap["histograms"])
    # the second wave (uids 4-7) waited for slots; the first did not
    first = [s.records[i].queue_wait_s for i in range(4)]
    second = [s.records[i].queue_wait_s for i in range(4, 8)]
    assert max(first) < min(second)
    for uid, rec in s.records.items():
        assert rec.n_tokens == 3
        assert rec.t_enqueue <= rec.t_admit <= rec.t_first_token \
            <= rec.t_finish
        assert validate_event(rec.to_event()) == []
        assert rec.to_event() == js.records[uid].to_event()
    n, errors = validate_jsonl(path)
    assert errors == [] and n == 8  # one request event per retirement
    assert [json.loads(x) for x in open(path)] == \
        [json.loads(x) for x in open(tmp_path / "jreq.jsonl")]


def test_request_record_status_marks_in_flight():
    """A snapshot taken mid-serve reports queued/in-flight requests with
    their partial timings instead of dropping them."""
    s = Scheduler(1)
    reqs = [Request(uid=i, prompt=[1, 2], max_new_tokens=2)
            for i in range(2)]
    s.submit_many(reqs, now=0.0)
    assert {r.status for r in s.records.values()} == {"queued"}
    s.admit(now=0.1)
    # uid 0 occupies the only slot; uid 1 still queued
    assert s.records[0].status == "in_flight"
    assert s.records[1].status == "queued"
    ev = s.records[0].to_event()
    assert ev["status"] == "in_flight" and ev["t_finish"] == 0.0
    assert validate_event(ev) == []
    for slot in s.active_slots():
        s.record_token(slot, 5, now=0.2)
        s.record_token(slot, 5, now=0.3)
    s.retire_done(now=0.3)
    assert s.records[0].status == "finished"
    assert s.records[0].to_event()["status"] == "finished"
    assert s.records[1].status == "queued"  # untouched by retirement


# ---------------------------------------------------------------------------
# realized-sparsity accumulation
# ---------------------------------------------------------------------------

def _support(idx_rows, u=2, b=3, k=4):
    """(U, B, 1, K) vals/idx with all winners non-zero."""
    idx = np.broadcast_to(np.asarray(idx_rows, np.int32), (u, b, 1, k))
    vals = np.ones((u, b, 1, k), np.float32)
    return vals, np.array(idx)


def test_sparsity_stats_overlap_and_reset():
    meta = {"ffn": {"d": 16, "kind": "support"}}
    both = []
    for st in (SparsityStats(reg := Registry()), JSparsityStats(JRegistry())):
        st.update({"ffn": _support([0, 1, 2, 3])}, meta,
                  active_rows=[0, 1, 2])
        st.update({"ffn": _support([0, 1, 2, 3])}, meta,
                  active_rows=[0, 1, 2])
        sm = st.summary()
        assert set(sm) == {"ffn.u0", "ffn.u1"}
        e = sm["ffn.u0"]
        assert e["realized_k_frac"] == pytest.approx(4 / 16)
        assert e["winner_overlap"] == pytest.approx(1.0)  # same supports
        assert e["k"] == 4 and e["d"] == 16
        # a fresh request in row 0 must not bridge overlap across requests
        st.reset_row(0)
        st.update({"ffn": _support([4, 5, 6, 7])}, meta,
                  active_rows=[0, 1, 2])
        e = st.summary()["ffn.u0"]
        # rows 1,2 contribute 0.0 overlap (disjoint), row 0 is suppressed:
        # mean over (3 prev samples of 1.0) + (2 new of 0.0) = 3/5
        assert e["winner_overlap"] == pytest.approx(3 / 5)
        both.append((st.summary(), st.probes, st._reg.snapshot()))
    assert both[0] == both[1]
    assert reg.snapshot()["counters"]["sparsity.probe_steps"] == 3


def test_sparsity_stats_overlap_compares_sets_not_orders():
    """Two top-k implementations may order tied winners differently: a
    permuted support is the same winner set."""
    meta = {"ffn": {"d": 16, "kind": "support"}}
    st = SparsityStats()
    st.update({"ffn": _support([0, 1, 2, 3])}, meta, active_rows=[0, 1])
    st.update({"ffn": _support([3, 1, 0, 2])}, meta, active_rows=[0, 1])
    assert st.summary()["ffn.u1"]["winner_overlap"] == 1.0


def test_sparsity_stats_nnz_path():
    nnz = np.full((2, 3, 1), 5, np.int32)  # (U, B, S=1)
    both = []
    for st in (SparsityStats(), JSparsityStats()):
        st.update({"ffn": (nnz,)}, {"ffn": {"d": 20, "kind": "nnz"}},
                  active_rows=[0, 2])
        both.append(st.summary())
    sm = both[0]
    assert sm["ffn.u0"]["realized_k_frac"] == pytest.approx(5 / 20)
    assert "winner_overlap" not in sm["ffn.u0"]  # no index form
    assert "k" not in sm["ffn.u0"]
    assert both[0] == both[1]


def test_capture_stacks_units_and_reads_back_once():
    """What a probed step records: labels from the site path, one entry a
    unit, and the tensors of every dtype the layers hand over (bf16
    values, int64 indices, int64 nnz) back as numpy, stacked (U, ...)."""
    rng = np.random.default_rng(0)
    vals = [torch.from_numpy(rng.standard_normal((3, 1, 4))).to(
        torch.bfloat16) for _ in range(2)]
    idx = [torch.from_numpy(rng.integers(0, 16, (3, 1, 4))) for _ in range(2)]
    y = torch.from_numpy(np.where(rng.random((2, 3, 1, 16)) < 0.5, 0.0,
                                  1.0).astype(np.float32))
    assert not obs_sparsity.capture_active()
    obs_sparsity.observe_support(vals[0], idx[0], 16)   # inactive: no-op
    with obs_sparsity.capture_supports() as cap:
        assert obs_sparsity.capture_active()
        for u in range(2):
            with obs_sparsity.observe_site("b0", unit=u), \
                    obs_sparsity.observe_site("ffn"):
                obs_sparsity.observe_support(vals[u], idx[u], 16)
                obs_sparsity.observe_activation(y[u], site="hist")
                obs_sparsity.observe_activation(y[u], site="hist")
    assert not obs_sparsity.capture_active()
    assert cap.meta == {"b0.ffn.kwta": {"d": 16, "kind": "support"},
                        "b0.ffn.hist": {"d": 16, "kind": "nnz"},
                        "b0.ffn.hist#2": {"d": 16, "kind": "nnz"}}
    host = cap.to_host()
    np.testing.assert_array_equal(
        host["b0.ffn.kwta"][0], np.stack([v.float().numpy() for v in vals]))
    np.testing.assert_array_equal(host["b0.ffn.kwta"][1],
                                  np.stack([i.numpy() for i in idx]))
    assert host["b0.ffn.kwta"][1].dtype == np.int64
    want = (y != 0).sum(-1).numpy()
    for label in ("b0.ffn.hist", "b0.ffn.hist#2"):
        assert host[label][0].dtype == np.int64
        np.testing.assert_array_equal(host[label][0], want)
    with obs_sparsity.capture_supports() as empty:
        pass
    assert empty.to_host() == {}


def _dispatch_events(jax_names):
    topk = {"path": "topk", "batch": 4, "d_in": 512, "d_out": 128, "n": 4,
            "k": 64}
    had = {"path": "hadamard", "batch": 4, "d_in": 128, "d_out": 512,
           "n": 4}
    back = ({"pallas": False, "interpret": False} if jax_names
            else {"backend": "torch"})
    return [dict(topk, **back), dict(had, **back)]


def test_dispatch_stats_seal_and_flop_shares():
    outs = []
    for ds, jax_names in ((DispatchStats(), False), (JDispatchStats(), True)):
        for ev in _dispatch_events(jax_names):
            ds.on_event(ev)
        ds.seal()
        ds.on_event({"path": "dense", "batch": 4, "d_in": 8, "d_out": 8})
        outs.append(ds.summary(decode_total_s=10.0))
    out, jout = outs
    assert set(out["paths"]) == {"topk[torch]", "hadamard[torch]"}  # sealed
    topk = 2.0 * 4 * 64 * 128
    had = 2.0 * 4 * 128 * 512 / 4
    assert out["sparse_flop_frac_est"] == pytest.approx(
        topk / (topk + had), abs=1e-6)
    assert out["decode_sparse_time_est_s"] + \
        out["decode_dense_time_est_s"] == pytest.approx(10.0)
    # the reference names the same backend "jnp"
    assert {k.replace("torch", "jnp"): v for k, v in out["paths"].items()} \
        == jout["paths"]
    assert {k: v for k, v in out.items() if k != "paths"} == \
        {k: v for k, v in jout.items() if k != "paths"}


def test_dispatch_stats_report_the_topk_launch_shared_memory():
    """A ``topk[cuda]`` site reports one block's shared memory of its
    launch: the launcher's dynamic bytes plus the kernel's static arrays
    (smollm-360m's down projection at decode, 4 slots, bf16 weights)."""
    from repro_torch.kernels.topk_gather import launch_geometry, static_smem
    ev = {"path": "topk", "backend": "cuda", "batch": 4, "d_in": 2560,
          "d_out": 960, "n": 4, "k": 320, "weight_bytes": 2}
    want = launch_geometry(4, 320, 240, 4, 2).smem + static_smem(2)
    assert est_topk_smem(ev) == want == 36896
    ds = DispatchStats()
    for _ in range(3):
        ds.on_event(ev)
    ds.on_event(dict(ev, backend="torch"))
    paths = ds.summary()["paths"]
    assert paths["topk[cuda]"] == {"sites": 3, "est_flops": 3 * 2.0 * 4
                                   * 320 * 960, "est_smem_bytes": 3 * want}
    assert "est_smem_bytes" not in paths["topk[torch]"]


# ---------------------------------------------------------------------------
# snapshot -> bench columns
# ---------------------------------------------------------------------------

def test_latency_and_sparsity_columns():
    reg = Registry()
    reg.histogram("serve.ttft_s").observe(0.1)
    h = reg.histogram("serve.itl_s")
    for v in (0.01, 0.02, 0.04):
        h.observe(v)
    snap = {
        "metrics": reg.snapshot(),
        "sparsity": {
            "layers": {"a": {"realized_k_frac": 0.1, "winner_overlap": 0.5},
                       "b": {"realized_k_frac": 0.3}},
            "paths": {"sparse_flop_frac_est": 0.25},
        },
    }
    lat = latency_columns(snap)
    assert lat["ttft_p50_ms"] == pytest.approx(100.0)
    assert lat == j_latency_columns(snap)
    assert latency_columns({"metrics": {"histograms": {}}}) == {}
    sp = sparsity_columns(snap)
    assert sp["realized_k_frac"] == pytest.approx(0.2)
    assert sp["winner_overlap"] == pytest.approx(0.5)
    assert sp["sparse_flop_frac_est"] == 0.25
    assert sp == j_sparsity_columns(snap)


# ---------------------------------------------------------------------------
# the decode step's graph with and without the hooks (make_fx)
# ---------------------------------------------------------------------------

# Nodes of the make_fx graph of the decode step below (smollm-360m reduced
# as the reference's tests/test_obs.py sizes it, 2 slots, position 4),
# counted before the telemetry hooks were added to the model.
NODES_WITHOUT_HOOKS = {"topk": 813, "bisect": 1281}


def _graph_cfg(kind):
    return get_config("smollm-360m").reduced(
        d_model=64, d_ff=256, vocab_size=128, n_heads=2, n_kv_heads=2,
        head_pad=0, compute_dtype="float32", param_dtype="float32",
        ffn_sparsity=SparsityConfig(n=4, k_frac=0.125, kwta_impl=kind))


@pytest.mark.parametrize("kind", sorted(NODES_WITHOUT_HOOKS))
def test_probe_adds_no_select_and_off_path_is_unchanged(kind):
    cfg = _graph_cfg(kind)
    params = T.init_model(cfg, seed=0, device="cpu")
    cache = T.init_cache(cfg, 2, 16, "cpu")
    toks = torch.ones((2, 1), dtype=torch.int64)

    def plain(p, c, t):
        return T.serve_step(p, c, {"tokens": t}, 4, cfg)[0]

    def probed(p, c, t):
        with obs_sparsity.capture_supports() as cap:
            logits, _ = T.serve_step(p, c, {"tokens": t}, 4, cfg)
        captured = [x for label in sorted(cap.entries)
                    for unit in sorted(cap.entries[label])
                    for x in cap.entries[label][unit]]
        return (logits, *captured)

    before = trace(plain, params, cache, toks)
    assert len(before.graph.nodes) == NODES_WITHOUT_HOOKS[kind]
    with observe_dispatch(lambda ev: None):
        observed = trace(plain, params, cache, toks)
    assert observed.code == before.code
    probe = trace(probed, params, cache, toks)
    # the probe returns the winner supports (or nnz) as extra outputs...
    outputs = [n for n in probe.graph.nodes if n.op == "output"][0].args[0]
    assert len(outputs) == 1 + cfg.n_layers * (2 if kind == "topk" else 1)
    # ...but adds NO Select: the supports are the ones the k-WTA layers
    # already computed (one top_k per sparse layer, unchanged)
    assert select_counts(probe) == select_counts(before)
    assert sum(select_counts(before).values()) > 0
    # exact top-k adds no op at all; bisect adds its nnz reduction (a
    # compare and a sum) once a layer
    extra = {"topk": 0, "bisect": 2 * cfg.n_layers}[kind]
    assert len(probe.graph.nodes) == len(before.graph.nodes) + extra
    # once the capture closes, the unprobed step traces as before
    assert trace(plain, params, cache, toks).code == before.code
    assert not obs_sparsity.capture_active()


def test_engine_probed_step_runs_the_same_layers_as_unprobed():
    """One engine decode step probed and one unprobed on the same cache
    state give the same logits bit for bit (the probe only reads)."""
    cfg = _graph_cfg("topk")
    eng = Engine(cfg, max_seq=16, n_slots=2, device="cpu")
    tokens = np.array([[3], [5]])
    pos = np.array([4, 6])
    outs = []
    for probed in (False, True):
        cache = eng.new_cache(2)
        logits, cap = eng._decode_step(cache, tokens, pos, probed=probed)
        outs.append(logits)
        assert (cap is not None) == probed
    np.testing.assert_array_equal(outs[0], outs[1])
    assert set(cap.meta) == {f"b{i}.ffn.kwta" for i in range(2)}
    host = cap.to_host()
    assert host["b0.ffn.kwta"][1].shape == (2, 2, 1, 32)   # (U, B, S, K)


def test_cli_telemetry_prints_the_snapshot_and_streams_jsonl(tmp_path,
                                                             capsys):
    from repro_torch.launch.serve import main as serve_main
    path = tmp_path / "events.jsonl"
    serve_main(["--arch", "smollm-360m", "--device", "cpu", "--requests",
                "2", "--gen", "3", "--prompt-len", "5",
                "--telemetry-jsonl", str(path)])
    out = capsys.readouterr().out
    line, snapshot = out.split("\n", 1)
    assert "served 2 requests on cpu" in line
    snap = json.loads(snapshot)
    assert snap["metrics"]["counters"]["serve.requests_finished"] == 2
    assert snap["sparsity"]["probe_steps"] > 0
    n, errors = validate_jsonl(str(path))
    assert errors == [] and n > 0
    assert export_main(["--validate", str(path)]) == 0
