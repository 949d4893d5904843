"""The port's distribution layer against the JAX package on the CPU: the
rule tables (``Rules.spec_for`` on every logical tuple the models use,
meshes (2, 2), (2, 4), (4, 2) and (2, 2, 2) with ``pod``, the four
kinds), every config's ``param_specs`` and ``cache_specs``, ZeRO-1's
``zero1_specs``, each rank's shard shapes against
``NamedSharding.shard_shape``, the int8 error-feedback sync on mesh
(2, 4) and GPipe on mesh (4,) over gloo (spawned ranks, as
tests/test_distributed.py runs them under ``shard_map``), and the mesh
constructors' refusals.  The JAX side uses the 8 fake CPU devices of
tests/conftest.py."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

import _torch_dist_ranks as ranks
from _zero1_reference import reference_replicates, zero1_shardings
from repro.configs import get_config as jget_config, list_archs
from repro.launch import mesh as jmesh_mod
from repro.launch import steps as JSt
from repro.models import gsc_cnn as JG
from repro.models import transformer as JT
from repro.optim import compression as jcomp
from repro.optim import init_residuals as j_init_residuals
from repro.runtime import bubble_fraction as j_bubble
from repro.runtime import pipeline_apply as j_pipeline_apply
from repro.sharding import make_rules as j_make_rules
from repro.sharding import param_sharding as j_param_sharding
from repro.sharding.context import shard_map as j_shard_map
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import (Mesh, make_mesh, make_production_mesh,
                                     single_device_mesh)
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.train import Trainer, parse_mesh
from repro_torch.models import gsc_cnn as G
from repro_torch.models import transformer as T
from repro_torch.optim import init_residuals
from repro_torch.runtime import bubble_fraction
from repro_torch.sharding import (NamedSharding, UnitSpec, make_rules,
                                  param_sharding)
from repro_torch.sharding.context import map_specs

needs_devices = pytest.mark.skipif(jax.device_count() < 8,
                                   reason="needs 8 fake CPU devices")

MESHES = [((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
KINDS = ("train", "prefill", "decode", "decode_long")
# activation tuples the reference's models constrain with
ACTIVATIONS = [("batch", "seq", "vocab"), ("batch", "vocab"),
               ("batch", "seq", None), ("batch", "seq", "heads", None),
               ("batch", "experts", None, None), ("batch", None, "mlp"),
               ("batch", "seq", "mlp"), ("batch", None)]


def _shape_mesh(dims, axes):
    return Mesh(tuple(dims), tuple(axes), torch.device("cpu"))


def _tuples(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _tuples(v, out)
    else:
        out.add(tuple(tree))
    return out


def _model_tuples():
    out = set(ACTIVATIONS)
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        _tuples(T.param_specs(cfg), out)
        _tuples(T.cache_specs(cfg), out)
    return sorted(out, key=str)


def _norm(tree):
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    return tuple(tree)


@needs_devices
@pytest.mark.parametrize("dims,axes", MESHES, ids=lambda v: str(v))
def test_rules_spec_for_matches_reference(dims, axes):
    jm = jmesh_mod.make_mesh(dims, axes)
    pm = _shape_mesh(dims, axes)
    tuples = _model_tuples()
    sizes = (1, 2, 3, 4, 6, 8, 16)
    n = 0
    for kind in KINDS:
        jr, pr = j_make_rules(jm, kind), make_rules(pm, kind)
        assert {k: jr.table[k] for k in jr.table} == pr.table
        for t in tuples:
            assert tuple(jr.spec_for(t)) == pr.spec_for(t), (kind, t)
            for shape in itertools.islice(
                    itertools.product(sizes, repeat=len(t)), 400):
                assert tuple(jr.spec_for(t, shape)) == \
                    pr.spec_for(t, shape), (kind, t, shape)
                n += 1
    assert n > 1000


def test_rules_fallback_and_repeated_axis():
    """tests/test_distributed.py's cases, and an axis used once a spec."""
    r = make_rules(_shape_mesh((2, 4), ("data", "model")), "train")
    assert r.spec_for(("batch", "heads"), (8, 6)) == ("data", None)
    assert r.spec_for(("batch", "heads"), (8, 8)) == ("data", "model")
    assert r.spec_for(("batch", None), (1, 8)) == (None, None)
    # heads and mlp both map to model: the second one replicates
    assert r.spec_for(("heads", "mlp"), (8, 8)) == ("model", None)
    d = make_rules(_shape_mesh((2, 4), ("data", "model")), "decode_long")
    assert d.spec_for(("batch", "kvseq", None, None),
                      (1, 64, 4, 16))[:2] == (None, ("data", "model"))


@pytest.mark.parametrize("arch", list_archs() + ["gsc_cnn"])
def test_param_specs_match_reference(arch):
    if arch == "gsc_cnn":
        for variant in ("dense", "sparse_dense", "sparse_sparse"):
            jc = dataclasses.replace(jget_config(arch), variant=variant)
            c = dataclasses.replace(get_config(arch), variant=variant)
            _, js = JG.init_model(jax.random.PRNGKey(0), jc)
            assert G.param_specs(c) == _norm(js)
        return
    jc, c = jget_config(arch).reduced(), get_config(arch).reduced()
    jparams, js = JT.init_model(jax.random.PRNGKey(0), jc)
    assert T.param_specs(c) == _norm(js)
    assert T.cache_specs(c) == _norm(JT.init_cache(jc, 2, 8)[1])
    # the port's layout: one UnitSpec a layer leaf, unit u of its block
    layers = T.layer_specs(T.param_specs(c), c)
    params = T.init_train_params(c, device="cpu")
    n = len(c.block_pattern)

    def check(spec, leaf, j=None):
        assert isinstance(leaf, torch.Tensor)
        if isinstance(spec, UnitSpec):
            assert spec.unit == j // n and spec.n_units == c.n_units
            assert len(spec.spec) == leaf.ndim + 1

    for j, (spec, layer) in enumerate(zip(layers["layers"],
                                          params["layers"])):
        map_specs(lambda s, p, j=j: check(s, p, j), spec, layer)
    assert sorted(layers) == sorted(params)


def _jshapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


ZERO_ARCHS = ("smollm-360m", "deepseek-v2-lite-16b", "zamba2-1.2b")
ZERO_MESHES = [((4, 2), ("data", "model")),
               ((2, 2, 2), ("pod", "data", "model"))]


@needs_devices
@pytest.mark.parametrize("arch", ZERO_ARCHS)
@pytest.mark.parametrize("dims,axes", ZERO_MESHES, ids=lambda v: str(v))
def test_zero1_specs_and_shard_shapes_match_reference(arch, dims, axes):
    """ZeRO-1 specs leaf for leaf (reference layout and the port's
    per-layer one), and every rank's block of every param and moment
    against ``NamedSharding.shard_shape`` of the reference's shardings."""
    jc, c = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = jmesh_mod.make_mesh(dims, axes)
    pm = _shape_mesh(dims, axes)
    jr, pr = j_make_rules(jm, "train"), make_rules(pm, "train")
    jparams, jspecs = JT.init_model(jax.random.PRNGKey(0), jc)
    jz = JSt.zero1_specs(jspecs, jparams, jr)
    specs = T.param_specs(c)
    z = St.zero1_specs(specs, _jshapes(jparams), pr)
    assert z == _norm(jz)
    params = T.init_train_params(c, device="cpu")
    layer_z = St.zero1_specs(T.layer_specs(specs, c), params, pr)
    assert layer_z == T.layer_specs(z, c)

    # per-rank blocks: the port's leaf of unit u is held whole by the
    # ranks whose block of the stacked leaf holds u
    jp_sh = jax.tree.leaves(j_param_sharding(jspecs, jparams, jr))
    mu = JSt.init_state(jparams, JSt.AdamWConfig())["mu"]
    assert reference_replicates(jz, mu, jr)
    jm_sh = jax.tree.leaves(zero1_shardings(jz, mu, jr))
    ref_p = [s.shard_shape(a.shape) for s, a in
             zip(jp_sh, jax.tree.leaves(jparams))]
    ref_m = [s.shard_shape(a.shape) for s, a in
             zip(jm_sh, jax.tree.leaves(mu))]
    leaf_paths = [jax.tree_util.keystr(k) for k, _ in
                  jax.tree_util.tree_flatten_with_path(jparams)[0]]
    p_sh = param_sharding(T.layer_specs(specs, c), params, pr)
    m_like = St.shard_train_state(
        params, c, TrainConfig(), pr)[2]["opt"]["mu"]
    from repro_torch.tree import flatten
    port_p = dict(flatten(p_sh))
    port_m = dict(flatten(m_like))
    shapes = {k: tuple(v.shape) for k, v in flatten(params)}
    n = len(c.block_pattern)
    names = list(pm.axis_names)
    for coords in itertools.product(*[range(d) for d in dims]):
        cd = dict(zip(names, coords))
        for path, rp, rm in zip(leaf_paths, ref_p, ref_m):
            keys = [k.strip("[]'") for k in path.split("][")]
            if keys[0] != "units":
                port = "/".join(keys)
                for sh, ref in ((port_p[port], rp), (port_m[port], rm)):
                    full = shapes[port] if ref != () else ()
                    blk = sh.block(full, cd)
                    assert tuple(s.stop - s.start for s in blk) == ref
                continue
            i = int(keys[1][1:])
            held = {"p": 0, "m": 0}
            for u in range(c.n_units):
                port = "/".join(["layers", str(u * n + i)] + keys[2:])
                for tag, sh, ref in (("p", port_p[port], rp),
                                     ("m", port_m[port], rm)):
                    full = shapes[port] if ref != () else ()
                    blk = sh.block(full, cd)
                    if blk is None:
                        continue
                    held[tag] += 1
                    want = ref[1:] if ref != () else ()
                    assert tuple(s.stop - s.start for s in blk) == want, \
                        (path, tag, coords)
            assert held["p"] == rp[0] and held["m"] == (rm[0] if rm else
                                                        c.n_units), path


def test_placements_and_blocks():
    mesh = _shape_mesh((2, 2), ("data", "model"))
    sh = NamedSharding(mesh, (None, "model"))
    assert sh.axes == ("model",)
    assert sh.shard_shape((8, 8)) == (8, 4)
    assert sh.block((8, 8), {"data": 1, "model": 1}) == (slice(0, 8),
                                                         slice(4, 8))
    dp = NamedSharding(mesh, (("data", "model"), None))
    assert dp.block((8, 3), {"data": 1, "model": 0}) == (slice(4, 6),
                                                         slice(0, 3))
    unit = NamedSharding(mesh, ("data", "model"), unit=(1, 2))
    assert unit.block((4,), {"data": 0, "model": 1}) is None
    assert unit.block((4,), {"data": 1, "model": 1}) == (slice(2, 4),)


def test_mesh_constructors_refuse_without_a_process_group(tmp_path):
    for call in (lambda: make_mesh((2, 2), ("data", "model"), "cpu"),
                 lambda: parse_mesh("2x2", "cpu")):
        with pytest.raises(RuntimeError, match="process group"):
            call()
    with pytest.raises(ValueError, match="two dims"):
        parse_mesh("4", "cpu")
    m = single_device_mesh("cpu")
    assert m.live and not m.distributed and m.group("data") is None
    prod = make_production_mesh(multi_pod=True, device="cpu")
    assert dict(prod.shape) == {"pod": 2, "data": 16, "model": 16}
    assert not prod.live
    with pytest.raises(RuntimeError, match="no process group"):
        prod.group("data")
    cfg = get_config("smollm-360m").reduced(n_layers=2)
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path)), prod,
                ShapeConfig("t", 8, 2, "train"))


# ---------------------------------------------------------------------------
# collectives over gloo: the int8 sync and GPipe
# ---------------------------------------------------------------------------

@needs_devices
def test_compressed_grad_sync_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    g = rng.normal(size=(2, 64)).astype(np.float32)
    m = rng.normal(size=(2, 3, 5)).astype(np.float32) * 1e-3
    res = run_ranks(ranks.compressed_sync, 8, tmp_path, args=(g, m))
    jm = jmesh_mod.make_mesh((2, 4), ("pod", "data"))

    def ref(x):
        """The reference's leaf under shard_map, pod p seeing row p."""
        def local(a, r):
            out, r_new = jcomp._ef_psum_leaf(a[0], r[0], "pod", 2)
            return out[None], r_new[None]
        r0 = j_init_residuals({"w": jnp.zeros(x.shape[1:])}, 2)["w"]
        out, r = j_shard_map(local, mesh=jm, in_specs=(P("pod"), P("pod")),
                             out_specs=(P("pod"), P("pod")),
                             check_vma=False)(jnp.asarray(x), r0)
        return np.asarray(out), np.asarray(r)

    (gw, rw), (gm, rm) = ref(g), ref(m)
    for r in res:
        p = r["pod"]
        np.testing.assert_allclose(r["out"]["w"], gw[p], rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["out"]["m"], gm[p], rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["resid"]["w"][0], rw[p], atol=1e-6)
        np.testing.assert_allclose(r["resid"]["m"][0], rm[p], atol=1e-6)
        np.testing.assert_allclose(r["leaf"], gw[p], atol=1e-6)
        np.testing.assert_allclose(r["leaf_resid"], rw[p], atol=1e-6)
        assert (r["out"]["i"] == np.arange(3)).all()
        # within the int8 step of the exact mean; residual = input - sent
        for x, name in ((g, "w"), (m, "m")):
            step = np.abs(x).max(axis=tuple(range(1, x.ndim))) / 127
            assert np.abs(r["out"][name] - x.mean(0)).max() <= step.max()
            sent = x[p] - r["resid"][name][0]
            assert np.abs(sent / (np.abs(x[p]).max() / 127)
                          - np.round(sent / (np.abs(x[p]).max() / 127))
                          ).max() < 1e-3
    assert {r["pod"] for r in res} == {0, 1}
    want = j_init_residuals({"w": jnp.zeros((64,)),
                             "i": jnp.zeros((3,), jnp.int32)}, 2)
    got = init_residuals({"w": torch.zeros(64),
                          "i": torch.zeros(3, dtype=torch.int32)}, 2)
    for k in ("w", "i"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).endswith(str(want[k].dtype))


@needs_devices
def test_pipeline_matches_reference_and_meshes_refuse_sizes(tmp_path):
    n_stages, d = 4, 16
    ws = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                      (n_stages, d, d)) / np.sqrt(d))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, d)))
    want = np.asarray(j_pipeline_apply(
        lambda w, a: jnp.tanh(a @ w), jmesh_mod.make_mesh((4,), ("pipe",)),
        "pipe", jnp.asarray(ws), jnp.asarray(x), n_micro=4))
    res = run_ranks(ranks.pipeline, 4, tmp_path, args=(ws, x))
    for y, refusals in res:
        np.testing.assert_allclose(y, want, rtol=0, atol=1e-5)
        assert all(m and "process group has 4" in m for m in refusals[:2])
        assert "process group has 4" in refusals[2]
    for s, m in ((4, 4), (2, 8), (1, 3)):
        assert bubble_fraction(s, m) == j_bubble(s, m)
