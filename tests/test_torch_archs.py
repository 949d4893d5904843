"""The four architectures of the SSM/hybrid and frontend slice against the
JAX package on the CPU, reduced, in float32, on the reference's
``init_model`` weights carried over by the bridge: zamba2-1.2b (Mamba2 +
the weight-shared attention block), xlstm-350m (mLSTM + sLSTM),
musicgen-large (precomputed ``embeds``) and internvl2-2b (a vision prefix
of ``patch_embeds``).

For each arch: ``forward`` logits within 2e-5, ``loss_fn`` within 1e-5,
every gradient leaf within 1e-5·(1+max|g|) of ``jax.value_and_grad``, and
eight ``serve_step`` positions (logits and cache) within 1e-5.  Then the
fused prefill of the frontends, ``generate_static`` tokens exact against
the JAX engine's on zamba2 and xlstm, decode against forward, what still
raises (``Engine.serve``, the paged layout, fused and chunked prefill on
SSM patterns), the shared block's layout (once in the params, the
serving params, the parameter count and a checkpoint; its own cache at
each invocation; its sparsity sites under both units), the cast rule of
the SSM leaves, and one training step of each arch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import batch_for as jbatch_for
from repro.launch.mesh import make_mesh
from repro.launch.serve import Engine as JEngine
from repro.models import transformer as JT
from repro_torch import checkpoint as ckpt
from repro_torch.bridge import params_from_jax, train_params_from_jax
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import canonical
from repro_torch.launch import steps as St
from repro_torch.launch.serve import Engine
from repro_torch.models import transformer as T
from repro_torch.obs import sparsity as obs_sparsity
from repro_torch.runtime.scheduler import Request
from repro_torch.tree import flatten

ARCHS = ["zamba2-1.2b", "xlstm-350m", "musicgen-large", "internvl2-2b"]
SSM_ARCHS = ["zamba2-1.2b", "xlstm-350m"]
BASE = dict(compute_dtype="float32", head_pad=0)


class _Shape:
    seq_len = 32
    global_batch = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite's parallel workers would otherwise
    oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    """A JAX tree as numpy; float0 (an int leaf's gradient) as int8 0s."""
    return jax.tree.map(lambda a: np.zeros(a.shape, np.int8)
                        if a.dtype == jax.dtypes.float0 else np.asarray(a),
                        tree)


def _cfgs(arch, **kw):
    return (jget_config(arch).reduced(**BASE, **kw),
            get_config(arch).reduced(**BASE, **kw))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=what)


def _step_batches(cfg, n, seed=11):
    """``n`` decode batches of 2 slots: tokens, or embeds for ``embed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if cfg.frontend == "embed":
            b = {"embeds": rng.normal(size=(2, 1, cfg.d_model))
                 .astype(np.float32)}
        else:
            b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 1))}
        out.append(b)
    return out


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(canonical(v)) for k, v in b.items()}


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    """One arch's configs, the reference's weights in both packages
    (serving and training layouts) and a training batch."""
    jcfg, cfg = _cfgs(request.param)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    npp = _np(jparams)
    batch = jbatch_for(jcfg, _Shape, step=0)
    return (request.param, jcfg, cfg, jparams,
            params_from_jax(npp, cfg, device="cpu"),
            train_params_from_jax(npp, cfg, device="cpu"), batch)


def test_forward_and_loss_match_reference(bridged):
    arch, jcfg, cfg, jparams, params, _, batch = bridged
    jlogits, _ = jax.jit(lambda p, b: JT.forward(p, b, jcfg))(
        jparams, _jax(batch))
    jloss, jm = jax.jit(lambda p, b: JT.loss_fn(p, b, jcfg))(
        jparams, _jax(batch))
    with torch.no_grad():
        logits, aux = T.forward(params, _torch(batch), cfg)
        loss, m = T.loss_fn(params, _torch(batch), cfg)
    # a vision prefix of n_prefix patches + 32 - n_prefix text tokens
    assert logits.shape == (2, 32, cfg.padded_vocab)
    _close(logits, jlogits, 2e-5, arch)
    assert float(aux) == float(jm["aux_loss"]) == 0.0
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert abs(float(m["lm_loss"]) - float(jm["lm_loss"])) <= 1e-5


def test_grads_match_reference(bridged):
    """Every leaf's gradient, zamba2's shared block's summed over both of
    its invocations, within 1e-5·(1+max|g|) of ``jax.value_and_grad``."""
    arch, jcfg, cfg, jparams, _, train, batch = bridged
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, _jax(batch), jcfg), has_aux=True,
        allow_int=True))(jparams)
    (loss, _), grads = St.value_and_grad(
        lambda p: T.loss_fn(p, _torch(batch), cfg), train)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    want = flatten(train_params_from_jax(_np(jgrads), cfg, device="cpu"))
    got = flatten(train)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, p), g, (_, w) in zip(got, grads, want):
        if not p.is_floating_point():
            assert g is None, k
            continue
        w = w.numpy()
        if g is None:     # unused (musicgen's token table): the reference's 0
            assert not w.any(), k
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=k,
                                   atol=1e-5 * (1 + np.abs(w).max()))


def _cache_from_jax(jcache, cfg):
    """The reference's stacked cache as the port's per-layer list."""
    n = len(cfg.block_pattern)
    return [{k: np.asarray(v[j // n])
             for k, v in jcache[f"b{j % n}"].items()}
            for j in range(cfg.n_layers)]


def test_serve_steps_match_reference(bridged):
    """Eight ``serve_step`` positions from an empty cache: logits and
    every cache leaf within 1e-5 of the reference's."""
    arch, jcfg, cfg, jparams, params, _, _ = bridged
    jstep = jax.jit(lambda p, c, b, pos: JT.serve_step(p, c, b, pos, jcfg))
    jcache, _ = JT.init_cache(jcfg, 2, 16)
    cache = T.init_cache(cfg, 2, 16, "cpu")
    for pos, b in enumerate(_step_batches(cfg, 8)):
        jlogits, jcache = jstep(jparams, jcache, _jax(b), pos)
        with torch.no_grad():
            logits, cache = T.serve_step(params, cache, _torch(b), pos, cfg)
        _close(logits, jlogits, 1e-5, f"{arch} position {pos}")
    for j, (c, r) in enumerate(zip(cache, _cache_from_jax(jcache, cfg),
                                   strict=True)):
        assert c.keys() == r.keys()
        for name in c:
            _close(c[name], r[name], 1e-5, f"{arch} layer {j} {name}")


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-2b"])
def test_frontend_prefill_matches_reference(arch):
    """The fused prefill from ``embeds`` (musicgen) or with the vision
    prefix's ``patch_embeds`` before the tokens (internvl2), then two
    decode steps after it: logits and caches within 1e-5."""
    jcfg, cfg = _cfgs(arch)
    jparams, _ = JT.init_model(jax.random.PRNGKey(2), jcfg)
    params = params_from_jax(_np(jparams), cfg, device="cpu")
    batch = {k: v for k, v in jbatch_for(jcfg, _Shape, step=1).items()
             if k != "labels"}
    batch = {k: v[:, :16] if k in ("tokens", "embeds") else v
             for k, v in batch.items()}
    rows = 16 + (cfg.n_prefix if cfg.frontend == "vision_prefix" else 0)
    jlogits, jcache = jax.jit(lambda p, b: JT.prefill(p, b, jcfg, 24))(
        jparams, _jax(batch))
    with torch.no_grad():
        logits, cache = T.prefill(params, _torch(batch), cfg, 24)
    assert logits.shape[1] == rows
    _close(logits, jlogits, 2e-5, arch)
    jstep = jax.jit(lambda p, c, b, pos: JT.serve_step(p, c, b, pos, jcfg))
    for i, b in enumerate(_step_batches(cfg, 2)):
        jl, jcache = jstep(jparams, jcache, _jax(b), rows + i)
        with torch.no_grad():
            lg, cache = T.serve_step(params, cache, _torch(b), rows + i, cfg)
        _close(lg, jl, 1e-5, f"{arch} step {i}")
    for c, r in zip(cache, _cache_from_jax(jcache, cfg), strict=True):
        for name in c:
            _close(c[name][:, :rows + 2], r[name][:, :rows + 2], 1e-5, name)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_generate_static_matches_jax_engine(arch):
    """Greedy tokens of the port's static engine equal the JAX engine's,
    token for token, on the JAX engine's own weights."""
    jcfg, cfg = _cfgs(arch)
    jeng = JEngine(jcfg, make_mesh((1, 1), ("data", "model")), max_seq=24,
                   n_slots=2)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8))
    want = jeng.generate_static(prompts, 8)
    eng = Engine(cfg, max_seq=24, n_slots=2, device="cpu",
                 params=params_from_jax(_np(jeng.params), cfg, device="cpu"))
    got = eng.generate_static(prompts, 8)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_matches_forward(arch):
    """Step-by-step decode reproduces the full forward's logits at every
    position (the reference's ``test_decode_matches_forward_ssm``, in
    float32)."""
    cfg = get_config(arch).reduced(**BASE)
    params = T.init_model(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        full, _ = T.forward(params, {"tokens": toks}, cfg)
        cache = T.init_cache(cfg, 2, 16, "cpu")
        for pos in range(16):
            logits, cache = T.serve_step(params, cache,
                                         {"tokens": toks[:, pos:pos + 1]},
                                         pos, cfg)
            _close(logits, full[:, pos].numpy(), 1e-4, f"position {pos}")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_patterns_refuse_what_the_reference_refuses(arch):
    """No fused prefill, no chunked prefill and no paged layout for
    patterns with SSM blocks; ``Engine.serve`` raises with the reference's
    wording."""
    cfg = get_config(arch).reduced()
    assert not T.supports_fused_prefill(cfg)
    eng = Engine(cfg, max_seq=16, n_slots=2, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="has no fused prefill; serve with "
                             "generate_static"):
        eng.serve([Request(uid=0, prompt=[1, 2], max_new_tokens=2)])
    with pytest.raises(NotImplementedError, match="attention-only"):
        T.init_paged_cache(cfg, 8, 8, "cpu")
    tokens = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    with pytest.raises(NotImplementedError, match="fused prefill not "
                       "implemented for block kind"):
        T.prefill(eng.params, tokens, cfg, 8)
    with pytest.raises(NotImplementedError, match="chunked prefill not "
                       "implemented for block kind"):
        T.prefill_chunk(eng.params, eng.new_cache(1), tokens, 0, 4, cfg,
                        torch.zeros((1, 1), dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="paged KV layout not "
                       "implemented for block kind"):
        T.serve_step(eng.params, eng.new_cache(1),
                     {"tokens": torch.zeros((1, 1), dtype=torch.int64)}, 0,
                     cfg, pages=torch.zeros((1, 1), dtype=torch.int64))


def test_shared_block_is_one_set_of_weights(tmp_path):
    """zamba2's shared attention block: once in the params (an empty dict
    at each of its layers), once in the parameter count (the reference's),
    one ``packed_p`` per packed layer in the bridged serving params and in
    those ``serving_params`` makes from the training layout, once in a
    checkpoint; each invocation has its own KV cache; its realized
    sparsity sites are ``b18`` under units 0 and 1."""
    jcfg, cfg = _cfgs("zamba2-1.2b")
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(_np(jparams), cfg, device="cpu")
    shared = [j for j, k in enumerate(T.layer_kinds(cfg))
              if k == "shared_attn"]
    assert shared == [18, 37]
    assert all(params["layers"][j] == {} for j in shared)
    assert T.param_count(params) == JT.param_count(jparams)
    keys = [k for k, _ in flatten(params)]
    # gelu: the shared FFN's up and down projections, both packed
    assert sum(k.endswith("packed_p") for k in keys) == \
        sum(k.endswith("/packed") for k in keys) == 2
    assert all(k.startswith("shared/ffn") for k in keys if "packed" in k)
    train = T.init_train_params(cfg, seed=0, device="cpu")
    served = [k for k, _ in flatten(T.serving_params(train, cfg))]
    assert sorted(k for k in served if "packed" in k) == \
        sorted(k for k in keys if "packed" in k)
    ckpt.save(str(tmp_path), 0, train)
    restored, _ = ckpt.restore(str(tmp_path), 0, train)
    paths = [k for k, _ in flatten(restored)]
    assert paths == [k for k, _ in flatten(train)]
    assert sum(p.startswith("shared/") for p in paths) == \
        len(flatten(train["shared"]))
    cache = T.init_cache(cfg, 2, 8, "cpu")
    assert cache[18]["k"].data_ptr() != cache[37]["k"].data_ptr()
    with torch.no_grad(), obs_sparsity.capture_supports() as cap:
        T.serve_step(params, cache,
                     {"tokens": torch.zeros((2, 1), dtype=torch.int64)}, 0,
                     cfg)
    assert cap.entries and {label.split(".")[0] for label in cap.entries} \
        == {"b18"}
    assert all(set(units) == {0, 1} for units in cap.entries.values())


def test_ssm_leaves_keep_the_reference_cast():
    """In bf16 serving params the SSM leaves that enter in float32 stay
    float32 (``A_log``, ``dt_bias``, ``gate_b`` and sLSTM's recurrent bias
    ``b``, whose name the linear layers' bias shares); every other weight
    is bf16.  A bf16 decode step and forward stay finite."""
    f32 = {"A_log", "dt_bias", "gate_b", "scale"}
    for arch in SSM_ARCHS:
        cfg = get_config(arch).reduced()
        params = T.init_model(cfg, seed=0, device="cpu")
        for k, t in flatten(params):
            name = k.rsplit("/", 1)[-1]
            if not t.is_floating_point():
                continue
            slstm_b = name == "b" and "/mixer/" in k
            want = torch.float32 if name in f32 or slstm_b else \
                torch.bfloat16
            assert t.dtype == want, (arch, k, t.dtype)
        toks = torch.ones((2, 16), dtype=torch.int64)
        with torch.no_grad():
            logits, _ = T.forward(params, {"tokens": toks}, cfg)
            step, _ = T.serve_step(params, T.init_cache(cfg, 2, 4, "cpu"),
                                   {"tokens": toks[:, :1]}, 0, cfg)
        assert logits.dtype == step.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits).all() and
                    torch.isfinite(step).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(arch):
    """The reference's ``test_forward_and_train_step`` for the port: one
    ``make_train_step`` step on a ``batch_for`` batch of the arch's
    frontend, finite, moves the params."""
    cfg = get_config(arch).reduced()
    params = T.init_train_params(cfg, seed=0, device="cpu")
    before = [t.clone() for _, t in flatten(params)]
    step, acfg = St.make_train_step(cfg, TrainConfig(lr=1e-3))
    from repro_torch.data import batch_for
    from repro_torch.optim import init_state
    opt = init_state(params, acfg)
    batch = _torch(batch_for(cfg, _Shape, step=0))
    _, _, m = step(params, opt, batch)
    assert np.isfinite(float(m["loss"])) and 0 < float(m["loss"]) < 20
    assert int(opt["step"]) == 1
    assert any(not torch.equal(a, b) for (_, a), b in
               zip(flatten(params), before) if a.is_floating_point())
