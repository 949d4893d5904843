"""The port's ``Engine`` on the MoE family against the JAX ``Engine``, in
float32 on the same bridged weights: deepseek-v2-lite reduced (MLA, MoE
with shared experts) and qwen3-moe reduced (GQA, MoE), token for token on
each KV layout; where the shared experts' down projection takes the
``topk`` path; and the serving CLI on deepseek-v2-lite."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.mesh import make_mesh
from repro.launch.serve import Engine as JEngine
from repro.runtime.scheduler import Request as JRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.topk_gather import topk_gather
from repro_torch.launch.serve import Engine
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import transformer as T
from repro_torch.runtime.scheduler import Request

BASE = dict(head_pad=0, compute_dtype="float32", param_dtype="float32")
ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b")


def _cfgs(arch, **overrides):
    kw = dict(BASE, **overrides)
    return jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


PLENS = [5, 19, 3, 26, 9, 14, 7, 22]
GENS = [6, 7, 8, 9, 10, 6, 7, 8]
LAYOUTS = {"contiguous": {},
           "paged": dict(kv_layout="paged", page_size=8, n_pages=13,
                         prefill_chunk=8)}


def _spec(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, n).tolist(), g)
            for n, g in zip(PLENS, GENS)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_the_jax_engine(arch, layout):
    """8 mixed-length requests on 4 slots, greedy: the port's tokens equal
    the JAX engine's on the same layout (the reference's own paged tokens
    differ from its contiguous ones here: a padded prefill bucket and a
    prefill chunk compete for expert capacity differently), and the
    shared experts' decode down projections reach the kernel wrapper
    (its plain version on the CPU)."""
    jcfg, cfg = _cfgs(arch)
    jeng = JEngine(jcfg, make_mesh((1, 1), ("data", "model")), max_seq=40,
                   n_slots=4, **LAYOUTS[layout])
    spec = _spec(cfg.vocab_size)
    jout, jstats = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=g)
                               for i, (p, g) in enumerate(spec)])
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg,
                             device="cpu")
    eng = Engine(cfg, max_seq=40, n_slots=4, params=params, device="cpu",
                 **LAYOUTS[layout])
    before = topk_gather.launches
    out, stats = eng.serve([Request(uid=i, prompt=p, max_new_tokens=g)
                            for i, (p, g) in enumerate(spec)])
    assert topk_gather.launches == before      # CPU: the plain version
    assert out == {u: [int(t) for t in v] for u, v in jout.items()}
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert stats["prefill_calls"] == len(spec)


def test_shared_experts_take_the_topk_path_at_decode_only():
    """deepseek-v2-lite reduced: the shared experts' down projection (d_ff
    128, K 16) takes ``topk`` at decode with 4 slots (4·16 < 128) and
    ``hadamard`` in prefill; the routed experts never dispatch."""
    from repro_torch.core.api import observe_dispatch
    _, cfg = _cfgs("deepseek-v2-lite-16b")
    params = T.init_model(cfg, seed=0, device="cpu")
    events = []
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with observe_dispatch(events.append):
        _, cache = T.prefill(params, {"tokens": toks}, cfg, 12)
    assert {e["path"] for e in events} == {"hadamard"}
    assert len(events) == 3 * cfg.n_layers     # shared up, gate, down
    cache = T.init_cache(cfg, 4, 12, device="cpu")
    events.clear()
    with observe_dispatch(events.append):
        T.serve_step(params, cache, {"tokens": torch.zeros(
            (4, 1), dtype=torch.int64)}, 3, cfg)
    downs = [e for e in events if e["d_in"] == 128]
    assert [e["path"] for e in downs] == ["topk"] * cfg.n_layers
    assert all(e["k"] == 16 for e in downs)


def test_cli_serves_deepseek_reduced_and_refuses_the_cpu_unasked(
        capsys, monkeypatch):
    serve_main(["--arch", "deepseek-v2-lite-16b", "--device", "cpu",
                "--requests", "2", "--gen", "3", "--prompt-len", "5"])
    assert "served 2 requests on cpu" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--arch", "deepseek-v2-lite-16b", "--requests", "1",
                    "--gen", "2"])
