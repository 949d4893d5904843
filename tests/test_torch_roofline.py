"""The port's roofline (``repro_torch.launch.roofline``, ``rooftool``)
against the reference's (``repro.launch.roofline``, ``rooftool``): the
active-parameter count of every shipped config, the three terms of a
hand-built record with the H100's constants and the record's rank count
mapped onto the reference's, and rooftool's lines on one results file.

The reference's roofline reads ``unit``·n_units + ``head`` (+ ``opt``);
the port's reads ``full``: the records below hold both, consistent."""

import json

import pytest

from repro.configs import get_config as ref_config
from repro.launch import roofline as RR
from repro.launch import rooftool as RT
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline as R
from repro_torch.launch import rooftool as PT


@pytest.mark.parametrize("arch", ARCH_IDS + ["gsc_cnn"])
def test_active_params_equal_the_reference(arch):
    if arch == "gsc_cnn":   # no decoder fields: both refuse it alike
        for fn, cfg in ((R.active_params, get_config(arch)),
                        (RR.active_params, ref_config(arch))):
            with pytest.raises(AttributeError):
                fn(cfg)
        return
    assert R.active_params(get_config(arch)) == RR.active_params(
        ref_config(arch))
    assert R.active_params(get_config(arch).reduced()) == RR.active_params(
        ref_config(arch).reduced())


def test_constants_are_the_h100s():
    assert (R.PEAK_FLOPS, R.F32_FLOPS, R.HBM_BW, R.NVLINK_BW) == (
        989e12, 67e12, 3.35e12, 450e9)


def _part(flops, nbytes, coll, f32=0.0):
    return {"cost": {"flops": flops + f32, "flops_bf16": flops,
                     "flops_f32": f32, "bytes_accessed": nbytes,
                     "transcendentals": 0.0},
            "collectives": {"total_bytes": coll},
            "memory": {"peak_bytes_est": 3.5e9}}


def record(kind, n_units=4, unit=(2e11, 4e8, 1e6), head=(5e10, 2e8, 2e5),
           opt=(1e9, 3e9, 5e7)):
    """A dry-run record whose ``full`` is n_units·unit + head (+ opt)."""
    parts = {"unit": _part(*unit), "head": _part(*head)}
    if kind == "train":
        parts["opt"] = _part(*opt)
    full = [0.0, 0.0, 0.0]
    for name, p in parts.items():
        mult = n_units if name == "unit" else 1
        full[0] += p["cost"]["flops"] * mult
        full[1] += p["cost"]["bytes_accessed"] * mult
        full[2] += p["collectives"]["total_bytes"] * mult
    return {"ok": True, "kind": kind, "n_units": n_units, "mesh": "16x16",
            "seq_len": 4096 if kind != "decode" else 32768,
            "global_batch": {"train": 256, "prefill": 32}.get(kind, 128),
            "full": _part(*full), **parts}


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's roofline with the H100's constants (its rank count
    is 256, the record's 16x16)."""
    monkeypatch.setattr(RR, "PEAK_FLOPS", R.PEAK_FLOPS)
    monkeypatch.setattr(RR, "HBM_BW", R.HBM_BW)
    monkeypatch.setattr(RR, "ICI_BW", R.NVLINK_BW)


KEYS = ("compute_s", "memory_s", "collective_s", "bottleneck", "bound_s",
        "model_flops_per_chip", "useful_fraction", "mfu_at_bound",
        "flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["smollm_360m", "deepseek_v2_lite_16b",
                                  "zamba2_1p2b"])
@pytest.mark.parametrize("scale", [(1.0, 1.0), (1e-3, 40.0), (1e-4, 1e-3)])
def test_cell_roofline_equals_the_reference(h100_reference, kind, arch,
                                            scale):
    fs, cs = scale      # move the bottleneck between the three terms
    rec = record(kind, unit=(2e11 * fs, 4e8, 1e6 * cs),
                 head=(5e10 * fs, 2e8, 2e5 * cs),
                 opt=(1e9 * fs, 3e9, 5e7 * cs))
    got = R.cell_roofline(rec, get_config(arch))
    want = RR.cell_roofline(rec, ref_config(arch))
    for k in KEYS:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_compute_term_splits_the_flops_by_operand_type():
    rec = record("decode")
    rec["full"] = _part(3e12, 1e9, 0.0, f32=2e11)
    rl = R.cell_roofline(rec)
    assert rl["compute_s"] == pytest.approx(3e12 / 989e12 + 2e11 / 67e12)
    assert rl["flops_per_chip"] == 3.2e12
    rec["mesh"] = "2x16x16"
    per = R.cell_roofline(rec, get_config("smollm_360m"))
    assert per["model_flops_per_chip"] == pytest.approx(
        R.cell_roofline(record("decode"), get_config("smollm_360m"))[
            "model_flops_per_chip"] / 2)


def test_failed_and_missing_records_have_no_roofline():
    assert R.cell_roofline({"ok": False, "error": "x"}) is None
    assert R.cell_roofline({"ok": True, "kind": "decode"}) is None


def test_rooftool_prints_the_reference_lines(h100_reference, tmp_path,
                                             capsys):
    results = {"smollm_360m|decode_32k|pod1": record("decode"),
               "smollm_360m|train_4k|pod1": record("train"),
               "zamba2_1p2b|decode_32k|pod1": {
                   "ok": False, "error": "NotImplementedError: zamba2-1.2b "
                                         "on mesh (16, 16): item 5"}}
    path = tmp_path / "results.json"
    path.write_text(json.dumps(results))
    keys = ["smollm_360m|", "zamba2_1p2b|decode_32k|pod1", "yi_6b|"]
    RT.show(str(path), keys)
    want = capsys.readouterr().out
    assert PT.main(["--results", str(path), *keys]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "memory-bound" in got and "FAILED" in got and "not found" in got


def test_analyze_and_markdown(tmp_path):
    results = {"smollm_360m|decode_32k|pod1": record("decode"),
               "smollm_360m|decode_32k|pod2": record("decode"),
               "yi_6b|train_4k|pod1": {"ok": False, "error": "x"}}
    src, out = tmp_path / "r.json", tmp_path / "roof.json"
    src.write_text(json.dumps(results))
    table = R.analyze(str(src), str(out))
    assert list(table) == ["smollm_360m|decode_32k"]
    assert json.loads(out.read_text()).keys() == table.keys()
    row = table["smollm_360m|decode_32k"]
    assert row["suggestion"] == R.SUGGESTIONS[("decode", row["bottleneck"])]
    md = R.to_markdown(table).splitlines()
    assert len(md) == 3 and md[2].startswith("| smollm_360m | decode_32k |")
    text = " ".join(R.SUGGESTIONS.values())
    assert "Pallas" not in text and "MXU" not in text
    assert R.SUGGESTIONS.keys() == RR.SUGGESTIONS.keys()


def test_the_io_floor_reads_the_census_argument_and_output_traffic():
    rec = record("decode")
    rec["full"]["memory"].update(argument_bytes=9.0e9,
                                 argument_read_bytes=3.0e9,
                                 argument_written_bytes=0.5e9,
                                 output_bytes=1.0e9)
    rl = R.cell_roofline(rec)
    assert rl["io_bytes_per_chip"] == 4.5e9
    assert rl["io_memory_s"] == pytest.approx(4.5e9 / 3.35e12)
    assert rl["floor_s"] == max(rl["compute_s"], rl["io_memory_s"],
                                rl["collective_s"])
    del rec["full"]["memory"]["argument_read_bytes"]
    assert "floor_s" not in R.cell_roofline(rec)
