"""Deterministic synthetic data: stateless, resumable, shard-aware.

Every sample is a pure function of (seed, step, index) via a counter-based
hash (splitmix64) — no generator state to checkpoint.  Restoring a training
run at step S reproduces exactly the batches that would have followed S
(the checkpoint only needs the step counter), and each data shard draws
disjoint index ranges, so the pipeline scales to any number of hosts.

Streams:
  * ``lm_batch``      — language-model token streams with Zipf-ish marginals
    and a local bigram dependency (so cross-entropy has learnable signal).
  * ``gsc_batch``     — GSC-shaped (32x32x1) 'audio spectrogram' images with
    class-dependent frequency patterns (12 keyword classes), mirroring the
    paper's keyword-spotting task shape.
  * ``embed_batch``   — precomputed frontend embeddings (audio/vlm stubs).

A copy of the reference's ``repro.data.synthetic`` (numpy only; the port
imports nothing of the reference): its batches are bit-identical.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _hash_uniform(seed: int, step: int, idx: np.ndarray) -> np.ndarray:
    """U[0,1) floats from (seed, step, flat index)."""
    base = np.uint64(seed) * np.uint64(0x100000001B3) + np.uint64(step)
    h = _splitmix64(idx.astype(np.uint64) ^ _splitmix64(
        np.full(idx.shape, base, np.uint64)))
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    """Token batch (local shard): tokens + labels (next-token).

    Tokens follow a Zipf-like marginal with a deterministic bigram twist:
    t[i] depends on t[i-1] 25% of the time (so a model can reduce loss
    below the unigram entropy).
    """
    b_local = batch // n_shards
    idx = (np.arange(b_local * (seq + 1), dtype=np.uint64)
           + np.uint64(shard * b_local * (seq + 1)))
    u = _hash_uniform(seed, step, idx).reshape(b_local, seq + 1)
    # Zipf-ish marginal via u^3 concentration
    toks = np.minimum((u ** 3 * vocab).astype(np.int64), vocab - 1)
    # bigram dependency: 25% of positions copy a hash of the predecessor
    dep = _hash_uniform(seed + 1, step, idx).reshape(b_local, seq + 1)
    prev = np.roll(toks, 1, axis=1)
    linked = (prev * 31 + 7) % vocab
    toks = np.where(dep < 0.25, linked, toks)
    return {"tokens": toks[:, :seq].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def gsc_batch(seed: int, step: int, batch: int, n_classes: int = 12,
              shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    """GSC-shaped synthetic keyword spectrograms (B, 32, 32, 1).

    Class c paints energy at 'formant' rows (frequencies) determined by c,
    plus noise — linearly separable enough that the paper's CNN trains to
    high accuracy in a few hundred steps on CPU."""
    b_local = batch // n_shards
    idx = (np.arange(b_local * 32 * 32, dtype=np.uint64)
           + np.uint64(shard * b_local * 32 * 32))
    noise = _hash_uniform(seed, step, idx).reshape(b_local, 32, 32, 1)
    labels = (_hash_uniform(seed + 2, step,
                            np.arange(b_local, dtype=np.uint64)
                            + np.uint64(shard * b_local))
              * n_classes).astype(np.int64)
    x = (noise - 0.5).astype(np.float32)
    rows = np.arange(32)
    for c in range(n_classes):
        f1, f2 = (3 * c + 2) % 32, (7 * c + 11) % 32
        pattern = ((rows[:, None] == f1) | (rows[:, None] == f2))
        mask = (labels == c)[:, None, None, None]
        x = x + 2.0 * mask * pattern[None, :, :, None].astype(np.float32)
    return {"x": x, "y": labels.astype(np.int32)}


def embed_batch(seed: int, step: int, batch: int, seq: int, d_model: int,
                vocab: int, shard: int = 0, n_shards: int = 1,
                prefix: int = 0) -> Dict[str, np.ndarray]:
    """Precomputed-frontend batches (audio 'embed' / vlm 'vision_prefix')."""
    b_local = batch // n_shards
    if prefix:  # vlm: text tokens + patch embeddings
        lm = lm_batch(seed, step, batch, seq - prefix, vocab, shard, n_shards)
        idx = (np.arange(b_local * prefix * d_model, dtype=np.uint64)
               + np.uint64(shard))
        pe = (_hash_uniform(seed + 3, step, idx)
              .reshape(b_local, prefix, d_model).astype(np.float32) - 0.5)
        return {"tokens": lm["tokens"], "labels": lm["labels"],
                "patch_embeds": pe}
    lm = lm_batch(seed, step, batch, seq, vocab, shard, n_shards)
    idx = (np.arange(b_local * seq * d_model, dtype=np.uint64)
           + np.uint64(shard))
    em = (_hash_uniform(seed + 4, step, idx)
          .reshape(b_local, seq, d_model).astype(np.float32) - 0.5)
    return {"embeds": em, "labels": lm["labels"]}


def batch_for(cfg, shape_or_none, step: int, seed: int = 0,
              batch: Optional[int] = None, seq: Optional[int] = None,
              shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    """Dispatch on the model's frontend."""
    b = batch or shape_or_none.global_batch
    s = seq or shape_or_none.seq_len
    if cfg.frontend == "embed":
        return embed_batch(seed, step, b, s, cfg.d_model, cfg.padded_vocab,
                           shard, n_shards)
    if cfg.frontend == "vision_prefix":
        return embed_batch(seed, step, b, s, cfg.d_model, cfg.vocab_size,
                           shard, n_shards, prefix=cfg.n_prefix)
    return lm_batch(seed, step, b, s, cfg.vocab_size, shard, n_shards)
