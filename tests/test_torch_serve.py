"""The port's serving engine: the scheduler and sampling tests of
tests/test_serving.py, mirrored; and the port's ``Engine`` against the JAX
``Engine`` on the same bridged weights (reduced smollm, float32, 8
requests on 4 slots) for the exact top-k FFN and the shipped bisect FFN.

Greedy outputs must be token-identical."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import SparsityConfig as JSparsity
from repro.launch.mesh import make_mesh
from repro.launch.serve import Engine as JEngine
from repro.runtime.scheduler import Request as JRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import SparsityConfig
from repro_torch.kernels.topk_gather import topk_gather
from repro_torch.launch.serve import Engine, _bucket
from repro_torch.launch.serve import build_parser, main as serve_main
from repro_torch.runtime.scheduler import (Request, SamplingParams, Scheduler,
                                           sample_token)


# ---------------------------------------------------------------------------
# scheduler (pure policy)
# ---------------------------------------------------------------------------

def _req(uid, p_len=4, max_new=8, **kw):
    return Request(uid=uid, prompt=list(range(p_len)),
                   max_new_tokens=max_new, **kw)


def test_scheduler_fifo_admission():
    s = Scheduler(2)
    s.submit_many([_req(0), _req(1), _req(2)])
    admitted = s.admit()
    assert [sl.request.uid for sl in admitted] == [0, 1]
    assert [sl.index for sl in admitted] == [0, 1]
    assert s.admit() == []           # no free slots
    assert [r.uid for r in s.queue] == [2]
    assert s.has_work


def test_scheduler_positions_start_at_prompt_len():
    s = Scheduler(1)
    s.submit(_req(7, p_len=5))
    (slot,) = s.admit()
    assert slot.pos == 5 and slot.generated == []


def test_scheduler_retire_frees_slot_and_readmits():
    s = Scheduler(1)
    s.submit_many([_req(0, max_new=2), _req(1, max_new=1)])
    (slot,) = s.admit()
    s.record_token(slot, 11)
    assert not slot.done
    s.record_token(slot, 12, now=0.5)
    assert slot.done
    retired = s.retire_done(now=0.5)
    assert [r.request.uid for r in retired] == [0]
    assert s.finished[0] == [11, 12]
    assert not s.slots[0].busy
    (slot2,) = s.admit()              # the queued request takes the slot
    assert slot2.request.uid == 1 and slot2.index == 0
    s.record_token(slot2, 3)
    s.retire_done()
    assert s.finished[1] == [3]
    assert not s.has_work
    ev = s.records[0].to_event()
    assert ev["status"] == "finished" and ev["n_tokens"] == 2
    assert ev["itl_mean_s"] == 0.5
    with pytest.raises(ValueError):
        Scheduler(0)


def test_scheduler_eos_retires_early():
    s = Scheduler(1)
    s.submit(_req(0, max_new=100, eos_id=42))
    (slot,) = s.admit()
    s.record_token(slot, 5)
    s.record_token(slot, 42)
    assert slot.done
    s.retire_done()
    assert s.finished[0] == [5, 42]


def test_sampling_greedy_and_topk():
    logits = np.asarray([0.0, 5.0, 1.0, 4.0])
    assert sample_token(logits, SamplingParams(), None) == 1
    rng = np.random.default_rng(0)
    picks = {sample_token(logits, SamplingParams(temperature=1.0, top_k=2),
                          rng) for _ in range(50)}
    assert picks <= {1, 3}            # top-2 filter holds
    assert len(picks) == 2            # and it actually samples
    a = [sample_token(logits, SamplingParams(temperature=0.7, seed=3),
                      np.random.default_rng(3)) for _ in range(5)]
    b = [sample_token(logits, SamplingParams(temperature=0.7, seed=3),
                      np.random.default_rng(3)) for _ in range(5)]
    assert a == b


def test_bucket_is_pow2_and_capped():
    assert _bucket(3, 64) == 8
    assert _bucket(9, 64) == 16
    assert _bucket(16, 64) == 16
    assert _bucket(60, 32) == 32


# ---------------------------------------------------------------------------
# the engine against the JAX engine, on the same weights
# ---------------------------------------------------------------------------

BASE = dict(head_pad=0, compute_dtype="float32", param_dtype="float32")
# the bench's exact top-k sparse-sparse FFN, and the shipped bisect FFN
# (reduced keeps it at n=4, route_share=0)
FFN = {"topk": dict(ffn_sparsity=dict(n=4, k_frac=0.125)), "bisect": {}}
N_REQ, N_SLOTS, MAX_SEQ, GEN = 8, 4, 32, 10


def _configs(kind):
    kw = dict(BASE)
    sp = FFN[kind].get("ffn_sparsity")
    jcfg = jget_config("smollm-360m").reduced(
        **kw, **({"ffn_sparsity": JSparsity(**sp)} if sp else {}))
    cfg = get_config("smollm-360m").reduced(
        **kw, **({"ffn_sparsity": SparsityConfig(**sp)} if sp else {}))
    return jcfg, cfg


def _prompts(vocab):
    rng = np.random.default_rng(5)
    # mixed lengths (two prefill buckets) and budgets: slots refill
    lens = [9, 12, 9, 16, 10, 9, 13, 9]
    budgets = [GEN, 3, GEN, 6, GEN, 2, GEN, 7]
    return [(rng.integers(0, vocab, n).tolist(), g)
            for n, g in zip(lens, budgets)]


@pytest.fixture(scope="module", params=sorted(FFN))
def engines(request):
    """(JAX engine, its outputs, port params, port config) per FFN kind;
    the JAX engine compiles once per module."""
    jcfg, cfg = _configs(request.param)
    jeng = JEngine(jcfg, make_mesh((1, 1), ("data", "model")),
                   max_seq=MAX_SEQ, n_slots=N_SLOTS)
    prompts = _prompts(cfg.vocab_size)
    jout, jstats = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=g)
                               for i, (p, g) in enumerate(prompts)])
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg,
                             device="cpu")
    return request.param, jout, jstats, params, cfg, prompts


def test_engine_serve_matches_jax_engine(engines):
    kind, jout, jstats, params, cfg, prompts = engines
    eng = Engine(cfg, max_seq=MAX_SEQ, n_slots=N_SLOTS, params=params,
                 device="cpu")
    assert eng.cfg.ffn_sparsity.use_pallas == "auto"
    reqs = [Request(uid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(prompts)]
    before = topk_gather.launches
    out, stats = eng.serve(reqs)
    assert topk_gather.launches == before      # CPU: the plain version
    assert sorted(out) == list(range(N_REQ))
    for i in range(N_REQ):
        assert out[i] == [int(t) for t in jout[i]], (kind, i)
    assert stats["prefill_calls"] == N_REQ == jstats["prefill_calls"]
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert len(stats["ttft_s"]) == N_REQ
    # the PyTorch-formula executor gives the same tokens
    off = Engine(cfg, max_seq=MAX_SEQ, n_slots=N_SLOTS, params=params,
                 use_pallas="off", device="cpu")
    out_off, _ = off.serve(reqs)
    assert out_off == out


def test_generate_static_matches(engines):
    """The static oracle of the port against the JAX engine's continuous
    outputs (which the reference's own tests pin to its static path)."""
    kind, jout, _, params, cfg, prompts = engines
    eng = Engine(cfg, max_seq=MAX_SEQ, n_slots=N_SLOTS, params=params,
                 device="cpu")
    same = [i for i, (p, g) in enumerate(prompts) if len(p) == 9 and g == GEN]
    batch = np.array([prompts[i][0] for i in same])
    static = eng.generate_static(batch, GEN)
    for row, i in zip(static, same):
        assert row.tolist() == [int(t) for t in jout[i]], (kind, i)


def test_engine_validates_requests():
    _, cfg = _configs("bisect")
    eng = Engine(cfg, max_seq=24, n_slots=2, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.serve([Request(uid=0, prompt=[1] * 20, max_new_tokens=8)])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.serve([Request(uid=0, prompt=[1], max_new_tokens=0)])
    with pytest.raises(ValueError, match="refusing to truncate"):
        eng._prefill(list(range(25)))
    out, stats = eng.serve([Request(uid=3, prompt=[1, 2], max_new_tokens=1,
                                    sampling=SamplingParams(temperature=1.0,
                                                            top_k=4))])
    assert len(out[3]) == 1 and stats["decode_steps"] == 0
    assert stats["prefill_calls"] == 1


def test_cli_runs_reduced_on_cpu(capsys):
    serve_main(["--arch", "smollm-360m", "--device", "cpu", "--requests",
                "2", "--gen", "3", "--prompt-len", "5"])
    line = capsys.readouterr().out
    assert "served 2 requests on cpu" in line and "2 prefill calls" in line


def test_cli_takes_the_reference_command_line(capsys):
    """The reference's command line (its ``--reduced`` included) parses
    as it does there, and serves."""
    argv = ["--arch", "smollm-360m", "--slots", "4", "--requests", "8",
            "--prompt-len", "16", "--gen", "24", "--reduced", "--device",
            "cpu"]
    args = build_parser().parse_args(argv)
    assert (args.arch, args.slots, args.requests, args.prompt_len,
            args.gen, args.reduced, args.full) == (
                "smollm-360m", 4, 8, 16, 24, True, False)
    assert build_parser().parse_args(argv[:-3] + argv[-2:]).reduced
    argv[5] = "2"                               # --requests 2
    serve_main(argv)
    line = capsys.readouterr().out
    assert "served 2 requests on cpu" in line and "2 prefill calls" in line


# ---------------------------------------------------------------------------
# the rest of the GQA family, and sampling, against the JAX engine
# ---------------------------------------------------------------------------

PAGED = dict(kv_layout="paged", page_size=8, prefill_chunk=8)


def _both_engines(jcfg, cfg, reqs, jreqs, **kw):
    """Tokens of the JAX engine and of the port's on its bridged weights,
    on one layout."""
    jeng = JEngine(jcfg, make_mesh((1, 1), ("data", "model")),
                   max_seq=MAX_SEQ, n_slots=N_SLOTS, **kw)
    jout, _ = jeng.serve(jreqs)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg,
                             device="cpu")
    out, _ = Engine(cfg, max_seq=MAX_SEQ, n_slots=N_SLOTS, params=params,
                    device="cpu", **kw).serve(reqs)
    return out, {u: [int(t) for t in v] for u, v in jout.items()}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["yi-6b", "minitron-8b", "starcoder2-15b"])
def test_gqa_family_serves_as_the_jax_engine(arch, layout):
    """Reduced float32 with ``head_pad=0``, 8 requests on 4 slots, greedy:
    token for token the JAX engine's (starcoder2: GELU, no gate)."""
    jcfg = jget_config(arch).reduced(**BASE)
    cfg = get_config(arch).reduced(**BASE)
    prompts = _prompts(cfg.vocab_size)
    out, want = _both_engines(
        jcfg, cfg,
        [Request(uid=i, prompt=p, max_new_tokens=g)
         for i, (p, g) in enumerate(prompts)],
        [JRequest(uid=i, prompt=p, max_new_tokens=g)
         for i, (p, g) in enumerate(prompts)],
        **({} if layout == "contiguous" else PAGED))
    assert out == want


@pytest.mark.parametrize("layout, temperature, top_k", [
    ("contiguous", 0.8, 5), ("paged", 0.8, 5), ("contiguous", 1.0, 0)])
def test_sampled_tokens_match_the_jax_engine(layout, temperature, top_k):
    """Sampling on the host from the same logits with the same per-request
    generator (seed = uid) draws the JAX engine's tokens: top-k 5 at
    temperature 0.8, and the full vocabulary at temperature 1.0."""
    from repro.runtime.scheduler import SamplingParams as JSampling
    jcfg, cfg = _configs("bisect")
    prompts = _prompts(cfg.vocab_size)
    out, want = _both_engines(
        jcfg, cfg,
        [Request(uid=i, prompt=p, max_new_tokens=g,
                 sampling=SamplingParams(temperature=temperature,
                                         top_k=top_k, seed=i))
         for i, (p, g) in enumerate(prompts)],
        [JRequest(uid=i, prompt=p, max_new_tokens=g,
                  sampling=JSampling(temperature=temperature, top_k=top_k,
                                     seed=i))
         for i, (p, g) in enumerate(prompts)],
        **({} if layout == "contiguous" else PAGED))
    assert out == want
