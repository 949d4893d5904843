"""The port's SSM blocks (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU, in float32, on inputs drawn
from numpy seeds: the chunked SSD scan, its decode step and the causal
conv (with and without its cache) within 1e-5, the scan's ``ValueError``
for a T the chunk does not divide, the reference's own SSD cases
(tests/test_models_blocks.py: the scan against the naive recurrence, a
decode step continuing the scan), and each mixer's apply and decode
(Mamba2, mLSTM, sLSTM) on the reference's ``*_init`` weights within
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import ssm as S

ATOL = 1e-5
MIXER_ARCH = {"mamba2": "zamba2-1.2b", "mlstm": "xlstm-350m",
              "slstm": "xlstm-350m"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite's parallel workers would otherwise
    oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _ssd_inputs(seed, b=2, t=32, h=2, dk=4, dv=6, scale=0.1):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, t, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, t, h, dv)).astype(np.float32)
    log_a = (-np.abs(rng.normal(size=(b, t, h))) * scale).astype(np.float32)
    return q, k, v, log_a


def _ssd_naive(q, k, v, log_a):
    """O(T) recurrence (tests/test_models_blocks.py's ``_ssd_naive``)."""
    b, t, h, dk = q.shape
    state = np.zeros((b, h, dk, v.shape[-1]), np.float32)
    ys = []
    for i in range(t):
        a = np.exp(log_a[:, i])[:, :, None, None]
        state = a * state + np.einsum("bhd,bhe->bhde", k[:, i], v[:, i])
        ys.append(np.einsum("bhd,bhde->bhe", q[:, i], state))
    return np.stack(ys, axis=1), state


@pytest.mark.parametrize("chunk", [4, 8, 16, 32, 64])
def test_ssd_scan_matches_reference(chunk):
    q, k, v, log_a = _ssd_inputs(chunk, scale=0.5)
    jy, jS = JS.ssd_scan(*map(jnp.asarray, (q, k, v, log_a)), chunk)
    y, fin = S.ssd_scan(*map(_t, (q, k, v, log_a)), chunk)
    assert y.dtype == torch.float32 and fin.dtype == torch.float32
    _close(y, jy)
    _close(fin, jS)


def test_ssd_scan_keeps_v_dtype_and_accumulates_in_f32():
    q, k, v, log_a = _ssd_inputs(1)
    bf = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    y, fin = S.ssd_scan(*bf, _t(log_a), 8)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    jy, jS = JS.ssd_scan(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         jnp.asarray(log_a), 8)
    _close(fin, jS, atol=1e-4)
    _close(y.float(), jnp.asarray(jy, jnp.float32), atol=3e-2)


def test_ssd_scan_rejects_a_t_the_chunk_does_not_divide():
    q, k, v, log_a = (_t(a) for a in _ssd_inputs(2, t=24))
    with pytest.raises(ValueError, match="T=24 not divisible by chunk=16"):
        S.ssd_scan(q, k, v, log_a, 16)
    with pytest.raises(ValueError, match="T=24 not divisible by chunk=16"):
        JS.ssd_scan(*(jnp.asarray(x.numpy()) for x in (q, k, v, log_a)), 16)


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("seed", [0, 7, 20])
def test_ssd_scan_matches_recurrence(chunk, seed):
    """The reference test's case: the chunked scan against the naive
    recurrence (its tolerance, 2e-3)."""
    q, k, v, log_a = _ssd_inputs(100 + seed)
    y, fin = S.ssd_scan(*map(_t, (q, k, v, log_a)), chunk)
    y_ref, S_ref = _ssd_naive(q, k, v, log_a)
    _close(y, y_ref, atol=2e-3)
    _close(fin, S_ref, atol=2e-3)


def test_ssd_step_matches_reference_and_continues_scan():
    """``ssd_step`` against the reference's within 1e-5, and (the
    reference test's case) a step from the scan's final state equals the
    scan over T+1."""
    t = 16
    q, k, v, log_a = _ssd_inputs(5, b=1, t=t + 1, dv=4)
    y_full, _ = S.ssd_scan(*map(_t, (q, k, v, log_a)), t + 1)
    _, S_t = S.ssd_scan(*(_t(a[:, :t]) for a in (q, k, v, log_a)), t)
    y_step, S_new = S.ssd_step(S_t, *(_t(a[:, t]) for a in (q, k, v, log_a)))
    _close(y_step, y_full[:, t].numpy(), atol=2e-3)
    jy, jS = JS.ssd_step(jnp.asarray(S_t.numpy()),
                         *(jnp.asarray(a[:, t]) for a in (q, k, v, log_a)))
    _close(y_step, jy)
    _close(S_new, jS)


@pytest.mark.parametrize("kk", [1, 2, 4])
def test_causal_conv_matches_reference(kk):
    rng = np.random.default_rng(kk)
    seq = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(kk, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    cache = rng.normal(size=(2, kk - 1, 12)).astype(np.float32)
    for c in (None, cache):
        jout, jnew = JS._causal_conv(jnp.asarray(seq), jnp.asarray(w),
                                     jnp.asarray(b),
                                     None if c is None else jnp.asarray(c))
        out, new = S._causal_conv(_t(seq), _t(w), _t(b),
                                  None if c is None else _t(c))
        _close(out, jout)
        _close(new, jnew)
    # streaming one step at a time gives the whole sequence's conv
    state = torch.zeros((2, kk - 1, 12))
    steps = []
    for i in range(seq.shape[1]):
        out, state = S._causal_conv(_t(seq[:, i:i + 1]), _t(w), _t(b), state)
        steps.append(out)
    _close(torch.cat(steps, dim=1), S._causal_conv(_t(seq), _t(w),
                                                   _t(b))[0].numpy())


# ---------------------------------------------------------------------------
# The mixers
# ---------------------------------------------------------------------------

def _mixer(kind, seed=0):
    """(jcfg, cfg, reference params, port params) of one mixer, reduced,
    float32, on the reference's ``*_init`` weights."""
    arch = MIXER_ARCH[kind]
    jcfg = jget_config(arch).reduced(compute_dtype="float32")
    cfg = get_config(arch).reduced(compute_dtype="float32")
    jp = getattr(JS, f"{kind}_init")(jax.random.PRNGKey(seed), jcfg)[0]
    # the reference initialises A_log, dt_bias and conv_b to 0: draw them,
    # so that their paths are held too
    if kind == "mamba2":
        rng = np.random.default_rng(seed)
        jp = dict(jp, **{name: jnp.asarray(
            rng.normal(size=jp[name].shape).astype(np.float32) * 0.5)
            for name in ("A_log", "dt_bias", "conv_b")})
    if kind == "slstm":
        rng = np.random.default_rng(seed)
        jp = dict(jp, b=jnp.asarray(
            rng.normal(size=jp["b"].shape).astype(np.float32)))
    return jcfg, cfg, jp, jax.tree.map(_t, jp)


def _x(cfg, t, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_mixer_apply_matches_reference(kind):
    jcfg, cfg, jp, p = _mixer(kind)
    x = _x(cfg, 2 * cfg.ssm_chunk)           # two SSD chunks
    want = getattr(JS, f"{kind}_apply")(jp, jnp.asarray(x), jcfg)
    got = getattr(S, f"{kind}_apply")(p, _t(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_mixer_decode_matches_reference(kind):
    """Eight decode steps from a zero state: outputs and every state leaf
    within 1e-5 of the reference's; the state leaves keep their types."""
    jcfg, cfg, jp, p = _mixer(kind, seed=1)
    x = _x(cfg, 8, seed=4)
    jcache = getattr(JS, f"{kind}_cache_init")(jcfg, 2, jnp.float32)
    cache = getattr(S, f"{kind}_cache_init")(cfg, 2, torch.float32)
    assert cache.keys() == jcache.keys()
    jdec = jax.jit(lambda p_, x_, c_: getattr(JS, f"{kind}_decode")(
        p_, x_, jcfg, c_, 0))
    for i in range(x.shape[1]):
        want, jcache = jdec(jp, jnp.asarray(x[:, i:i + 1]), jcache)
        got, cache = getattr(S, f"{kind}_decode")(p, _t(x[:, i:i + 1]), cfg,
                                                   cache, i)
        _close(got, want)
        for name in cache:
            _close(cache[name], jcache[name])
    # the state types: S, c, n in f32; h and the conv cache in the
    # compute dtype
    bf = getattr(S, f"{kind}_cache_init")(cfg, 2, torch.bfloat16)
    want_types = {"S": torch.float32, "c": torch.float32, "n": torch.float32,
                  "h": torch.bfloat16, "conv": torch.bfloat16}
    assert {k: v.dtype for k, v in bf.items()} == \
        {k: want_types[k] for k in bf}


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_mixer_decode_continues_apply(kind):
    """Decoding a sequence token by token gives the full-sequence apply."""
    _, cfg, _, p = _mixer(kind, seed=2)
    x = _t(_x(cfg, cfg.ssm_chunk, seed=5))
    full = getattr(S, f"{kind}_apply")(p, x, cfg)
    cache = getattr(S, f"{kind}_cache_init")(cfg, 2, torch.float32)
    rows = []
    for i in range(x.shape[1]):
        y, cache = getattr(S, f"{kind}_decode")(p, x[:, i:i + 1], cfg, cache,
                                                i)
        rows.append(y)
    _close(torch.cat(rows, dim=1), full.numpy(), atol=1e-4)


def test_ssd_scan_checkpoints_each_chunk_without_changing_values(
        monkeypatch):
    """Each chunk of ``ssd_scan`` runs under ``torch.utils.checkpoint``
    where autograd records (the reference's ``@jax.checkpoint``): the
    chunk is computed again in the backward pass, and values and
    gradients equal a run without it."""
    rng = np.random.default_rng(5)
    b, t, h, dk, dv = 2, 32, 3, 4, 5
    arrays = [rng.normal(size=(b, t, h, d)).astype(np.float32)
              for d in (dk, dk, dv)]
    log_a = -np.abs(rng.normal(size=(b, t, h))).astype(np.float32)
    calls = {"n": 0}
    chunk = S._ssd_chunk

    def counted(*a):
        calls["n"] += 1
        return chunk(*a)

    monkeypatch.setattr(S, "_ssd_chunk", counted)

    def run():
        xs = [torch.tensor(a, requires_grad=True) for a in arrays]
        la = torch.tensor(log_a, requires_grad=True)
        y, state = S.ssd_scan(*xs, la, chunk=8)
        (y.square().sum() + state.sum()).backward()
        return [y.detach(), state.detach()] + [x.grad for x in xs + [la]]

    calls["n"] = 0
    remat = run()
    assert calls["n"] == 2 * (t // 8)       # forward, then again backward
    monkeypatch.setattr(S, "checkpoint",
                        lambda fn, *a, use_reentrant: fn(*a))
    calls["n"] = 0
    plain = run()
    assert calls["n"] == t // 8
    for a, p in zip(remat, plain):
        assert torch.equal(a, p)
    with torch.no_grad():
        calls["n"] = 0
        S.ssd_scan(*[torch.from_numpy(a) for a in arrays],
                   torch.from_numpy(log_a), chunk=8)
    assert calls["n"] == t // 8
