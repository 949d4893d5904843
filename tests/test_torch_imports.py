"""The port stands alone: no module of ``repro_torch`` nor ``chip_smoke.py``
imports JAX or the reference package, and its entry points refuse to run
on the CPU unless asked to."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.bridge import (gsc_params_from_jax, params_from_jax,
                                train_params_from_jax)
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.launch.serve import Engine
from repro_torch.launch.train import Trainer, main as train_main
from repro_torch.models import gsc_cnn as G
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_module_loads_neither_jax_nor_the_reference():
    mods = _modules()
    assert "repro_torch.kernels.topk_gather" in mods and len(mods) >= 30
    assert {"repro_torch.models.moe", "repro_torch.models.attention",
            "repro_torch.models.transformer"} <= set(mods)
    assert {"repro_torch.runtime.kvcache",
            "repro_torch.runtime.kvcache.allocator",
            "repro_torch.runtime.kvcache.layout"} <= set(mods)
    assert {f"repro_torch.analysis.{m}" for m in (
        "__main__", "findings", "fixtures", "graph_rules", "graph_walk",
        "kernel_checks", "lint", "rules", "seeded")} <= set(mods)
    assert {f"repro_torch.obs.{m}" for m in (
        "export", "metrics", "sparsity", "trace")} <= set(mods)
    assert {"repro_torch.checkpoint.ckpt", "repro_torch.configs.gsc_cnn",
            "repro_torch.data.pipeline", "repro_torch.data.synthetic",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.models.gsc_cnn", "repro_torch.optim.adamw",
            "repro_torch.optim.compression", "repro_torch.optim.schedule",
            "repro_torch.runtime.monitor", "repro_torch.tree"} <= set(mods)
    assert {"repro_torch.sharding", "repro_torch.sharding.axes",
            "repro_torch.sharding.collectives",
            "repro_torch.sharding.context", "repro_torch.launch.mesh",
            "repro_torch.launch.ranks",
            "repro_torch.runtime.pipeline_parallel"} <= set(mods)
    assert {f"repro_torch.launch.{m}" for m in (
        "dryrun", "hlo", "roofline", "rooftool")} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_obs_imports_nothing_of_core_or_models():
    """The reference's module rule (``repro/obs/sparsity.py``): the hooks
    point from core and models to obs, never back, so a capture can be
    active while those modules run."""
    mods = [m for m in _modules() if m == "repro_torch.obs"
            or m.startswith("repro_torch.obs.")]
    assert len(mods) == 5
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(k for k in sys.modules if k.startswith("
            "('repro_torch.core', 'repro_torch.models', 'repro_torch.launch',"
            " 'repro_torch.kernels', 'jax', 'repro.'))))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    for f in sorted((PORT / "obs").glob("*.py")):
        text = f.read_text()
        assert not re.search(r"^\s*(from|import)\s+(repro_torch\.)?"
                             r"(core|models)\b", text, re.M), f
        assert not re.search(r"^\s*from\s+\.\.(core|models)", text,
                             re.M), f


def test_the_fake_process_group_is_imported_only_inside_the_dry_run():
    """``torch.testing._internal.distributed.fake_pg`` is internal to
    torch: one function of the dry run imports it, when it runs."""
    users = [f for f in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             if "fake_pg" in f.read_text()]
    assert users == [PORT / "launch" / "dryrun.py"]
    imports = re.findall(r"^(\s*)from torch\.testing\._internal\S* import",
                         users[0].read_text(), re.M)
    assert imports == ["    "]
    code = ("import sys, repro_torch.launch.dryrun\n"
            "print('torch.testing._internal.distributed.fake_pg' in "
            "sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_no_source_file_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        text = f.read_text()
        assert not IMPORT_RE.search(text), f
        assert "import jax" not in text, f


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_unless_asked(no_cuda):
    cfg = get_config("smollm-360m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, max_seq=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, max_seq=16, kv_layout="paged")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"units": {}}, cfg)
    eng = Engine(cfg, max_seq=16, device="cpu")
    assert eng.device.type == "cpu"
    paged = Engine(cfg, max_seq=16, device="cpu", kv_layout="paged")
    assert paged.new_paged_cache()[0]["k"].device.type == "cpu"


def test_training_entry_points_refuse_the_cpu_unless_asked(no_cuda,
                                                          tmp_path,
                                                          monkeypatch):
    cfg = get_config("smollm-360m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single_device_mesh()
    # under torchrun, before any process group is joined
    with monkeypatch.context() as env:
        env.setenv("WORLD_SIZE", "4")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(["--arch", "smollm-360m", "--mesh", "2x2",
                        "--ckpt-dir", str(tmp_path)])
    shape = ShapeConfig("t", 8, 2, "train")
    tcfg = TrainConfig(ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, tcfg, (1, 1), shape)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--arch", "smollm-360m", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_train_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.init_model(G.GSCConfig())
    for bridge in (lambda: train_params_from_jax({"units": {}}, cfg),
                   lambda: gsc_params_from_jax({})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bridge()
    trainer = Trainer(cfg, tcfg, (1, 1), shape, device="cpu")
    assert {t.device.type for t in trainer.opt["mu"]["final_norm"].values()
            } == {"cpu"}


def test_train_cli_without_a_card_exits_nonzero(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--steps", "1", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not list(tmp_path.iterdir())


EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))


def test_the_four_examples_are_ported():
    assert [f.name for f in EXAMPLES] == [
        "quickstart_torch.py", "serve_lm_torch.py",
        "sparse_sparse_lm_torch.py", "train_gsc_torch.py"]


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda f: f.stem)
def test_examples_load_neither_jax_nor_the_reference(example):
    """Each example, imported in a fresh interpreter (its ``__main__``
    block not run), loads no JAX module and no module of the reference."""
    assert not IMPORT_RE.search(example.read_text())
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('ex', "
            f"{str(example)!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "print(bad, 'repro_torch' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[] True"


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda f: f.stem)
def test_examples_without_a_card_exit_nonzero(example):
    """With no CUDA device and no ``--device cpu``, each example exits
    non-zero, naming the missing device, before it prints a result."""
    res = subprocess.run(
        [sys.executable, str(example)], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                              CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""
