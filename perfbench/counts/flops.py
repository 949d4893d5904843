"""FLOPs of a decode step and of a training step from the shapes alone:
the work the sparse-sparse algorithm needs, not what the program's eager
path happens to launch.

* A dense product (B, d_in) x (d_in, d_out): 2·B·d_in·d_out
  (``flops_dense``, frozen from ``repro_torch.core.functional``).
* A packed complementary-sparse product (density 1/N): 2·B·d_in·d_out/N
  (``flops_cs_matmul``, frozen from the same module).
* A down projection fed by the k-WTA: each of the K winners meets the
  d_out/N weights its partition routes to it: 2·B·K·d_out/N.  (The
  program's ``flops_cs_topk`` counts 2·B·K·d_out, the masked multiply the
  kernel does; the algorithm needs 1/N of it.)
* Attention over a context of c keys: 2·H·c·(d_qk + d_v) a query.
  MLA decodes in its absorbed form: the query's nope part into the latent
  (2·H·d_nope·r), scores over latent and rope key (2·H·c·(r + d_r)),
  values in the latent (2·H·c·r) and out of it (2·H·r·d_v).
* The LM head: 2·d·V a token.  Embedding lookups, norms, the k-WTA, RoPE
  and softmax are not counted.
"""

from __future__ import annotations


def flops_dense(batch: int, d_in: int, d_out: int) -> int:
    return 2 * batch * d_in * d_out


def flops_cs_matmul(batch: int, d_in: int, d_out: int, n: int) -> int:
    return 2 * batch * d_in * d_out // n


def _ffn_token(d: int, f: int, sp) -> int:
    """One token through a SwiGLU FFN of width f with packed weights and
    the k-WTA on its hidden."""
    k = sp.k_for(f)
    return 2 * flops_cs_matmul(1, d, f, sp.n) + 2 * k * d // sp.n


def token_weights_flops(cfg) -> int:
    """Every weight product one token needs, attention's context aside."""
    d, sp = cfg.d_model, cfg.ffn_sparsity
    h, dh = cfg.n_heads, cfg.head_dim
    if cfg.use_mla:
        r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
        attn = (flops_dense(1, d, h * (dh + dr)) + flops_dense(1, d, r + dr)
                + flops_dense(1, h * dh, d))
    else:
        hkv = cfg.n_kv_heads
        attn = flops_dense(1, d, (h + 2 * hkv) * dh) + flops_dense(1, h * dh, d)
    if cfg.is_moe:
        ffn = (flops_dense(1, d, cfg.n_experts)
               + cfg.experts_per_token * _ffn_token(d, cfg.d_ff, sp)
               + _ffn_token(d, cfg.n_shared_experts * cfg.d_ff, sp))
    else:
        ffn = _ffn_token(d, cfg.d_ff, sp)
    return cfg.n_layers * (attn + ffn) + flops_dense(1, d, cfg.vocab_size)


def decode_attention_flops(cfg, context: int) -> int:
    """One decode token's attention over ``context`` keys, every layer."""
    h, dh = cfg.n_heads, cfg.head_dim
    if cfg.use_mla:
        r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
        per = (2 * h * dh * r + 2 * h * context * (r + dr)
               + 2 * h * context * r + 2 * h * r * dh)
    else:
        per = 2 * h * context * 2 * dh
    return cfg.n_layers * per


def decode_step_flops(cfg, contexts) -> int:
    """A decode step of the rows whose contexts (keys each attends,
    itself included) are ``contexts``."""
    return sum(token_weights_flops(cfg) + decode_attention_flops(cfg, c)
               for c in contexts)


def train_step_flops(cfg, batch: int, seq: int) -> int:
    """Forward and backward (3x the forward) of ``batch`` rows of ``seq``
    tokens: every weight product a token needs, and causal attention
    (query i attends i + 1 keys); remat's recompute not counted."""
    h, dh = cfg.n_heads, cfg.head_dim
    attn = cfg.n_layers * 2 * h * 2 * dh * (seq * (seq + 1) // 2)
    return 3 * batch * (seq * token_weights_flops(cfg) + attn)
