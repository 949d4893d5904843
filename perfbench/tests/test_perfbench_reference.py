"""The plain references against the port on the CPU, at the port's
reduced sizes in float32: served tokens lie at the reference's best logit,
and the full-sequence logits agree."""

import dataclasses

import pytest
import torch

from _perfbench_util import hook, run_small, small_cell
from harness.model_cfg import port_config
from harness.spec import reference_module
from harness.weights import draw
from reference.common import Prec, Seq, exact_f32


@pytest.mark.parametrize("name", ["smollm-360m.chat4",
                                  "deepseek-v2-lite-16b.chat4"])
def test_served_tokens_at_reference_best(name):
    cell, out = run_small(name)
    d = out["check_detail"]
    assert d["tokens_checked"] >= 64 and d["parted_share"] == 0
    assert d["logit_gap"] <= 1e-5 and d["mean_gap"] <= 1e-6
    assert out["failed"] == 0


@pytest.mark.parametrize("name", ["smollm-360m.chat4",
                                  "deepseek-v2-lite-16b.chat4"])
def test_full_sequence_logits_agree(name):
    from repro_torch.models import transformer as T
    cell = small_cell(name)
    cfg, conf = hook()(port_config(cell.config), cell.config)
    assert cfg.tie_embeddings == conf["tie_word_embeddings"]
    w = draw(cfg, 5, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 24),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _ = T.forward(w, {"tokens": toks}, cfg)
    s = toks.shape[1]
    seq = Seq(toks[0], torch.arange(s), torch.ones(s, s).tril().bool(),
              torch.arange(s), [torch.arange(s)])
    with torch.no_grad(), exact_f32():
        got = reference_module(conf["model_type"]).served_logits(
            conf, w, [seq], Prec("f32"))[0]
    torch.testing.assert_close(got, want[0].float(), atol=2e-5, rtol=1e-5)


def test_dense_of_packed_matches_port():
    from repro_torch.core.functional import decompress
    from reference.common import dense_of_packed
    g = torch.Generator().manual_seed(1)
    packed = torch.randn(6, 5, 4, generator=g)
    for tables in (1, 3, 6):
        route = torch.rand(tables, 5, 4, generator=g).argsort(-1).to(
            torch.int8)
        torch.testing.assert_close(dense_of_packed(packed, route),
                                   decompress(packed, route))


@pytest.mark.parametrize("name", ["smollm-360m.chat4",
                                  "deepseek-v2-lite-16b.chat4"])
def test_fp8_control_parts_from_the_reference(name):
    """The control's machinery at the reduced size: the reference in fp8
    puts other tokens first than the float32 reference does."""
    from harness import serve as SV
    from harness import traffic as TR
    cell = small_cell(name)
    cfg, conf = hook()(port_config(cell.config), cell.config)
    w = draw(cfg, 9, "cpu")
    eng = SV.engine_for(cfg, w, cell.traffic, "cpu")
    calls = [SV.serve_call(eng, TR.ServeStream(cell.traffic, cfg.vocab_size,
                                               9).call(0))]
    ref = reference_module(conf["model_type"])
    found = SV.check_served(conf, w, SV.finished(calls),
                            cell.traffic["max_seq"], ref, "cpu",
                            with_pads=cfg.is_moe, control=True)
    assert found["logit_gap"] <= 1e-5 < found["control_logit_gap"]
    assert found["control_parted_share"] > 0


@pytest.mark.parametrize("name", ["smollm-360m.chat4",
                                  "deepseek-v2-lite-16b.chat4"])
def test_fp8_weights_control_parts_from_the_reference(name):
    """The card control's machinery at the reduced size: the program
    serving its weights rounded to fp8 puts other tokens first than the
    float32 reference on the weights as drawn, and those weights are a
    copy (the drawn ones stay as they were)."""
    import importlib.util

    from _perfbench_util import BENCH
    from harness import serve as SV
    from harness import traffic as TR
    spec = importlib.util.spec_from_file_location(
        "perfbench_control_serve", BENCH / "controls" / "serve.py")
    ctl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ctl)
    cell = small_cell(name)
    cfg, conf = hook()(port_config(cell.config), cell.config)
    w = draw(cfg, 9, "cpu")
    low = ctl.fp8_weights(w, cfg)
    assert torch.equal(w["embed"]["table"], draw(cfg, 9, "cpu")["embed"][
        "table"])
    head = "embed" if cfg.tie_embeddings else "head"
    assert not torch.equal(low[head]["table"], w[head]["table"])
    assert torch.equal(low["layers"][0]["norm1"]["scale"],
                       w["layers"][0]["norm1"]["scale"])
    eng = SV.engine_for(cfg, low, cell.traffic, "cpu")
    calls = [SV.serve_call(eng, TR.ServeStream(cell.traffic, cfg.vocab_size,
                                               9).call(0))]
    found = SV.check_served(conf, w, SV.finished(calls),
                            cell.traffic["max_seq"],
                            reference_module(conf["model_type"]), "cpu",
                            with_pads=cfg.is_moe, control=True)
    assert found["logit_gap"] > 1e-3 and found["parted_share"] > 0
    assert found["gap_share"] > 0
