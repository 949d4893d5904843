"""The program's model configuration for a configuration file.

A file names the port's configuration it is run with (``port.arch``); the
harness takes that configuration, sets on it the published keys that are
plain fields of it (``FROM_FILE``), and checks, key by key, that the
sizes the file states (the published keys, with the changes ``reduced``
lists, and the assumed sparsity) are the ones the port computes.  A file
and a program that disagree stop the run before anything is timed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

#: published keys the harness sets on the port's configuration from the
#: file: {file key: ``ModelConfig`` field}
FROM_FILE = {"rms_norm_eps": "norm_eps",
             "tie_word_embeddings": "tie_embeddings"}


def _llama_keys(cfg) -> Dict:
    return {"hidden_size": cfg.d_model,
            "intermediate_size": cfg.d_ff,
            "num_attention_heads": cfg.n_heads,
            "num_hidden_layers": cfg.n_layers,
            "num_key_value_heads": cfg.n_kv_heads,
            "rms_norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_embeddings,
            "vocab_size": cfg.vocab_size,
            "hidden_act": cfg.act}


def _deepseek_v2_keys(cfg) -> Dict:
    return {"hidden_size": cfg.d_model,
            "moe_intermediate_size": cfg.d_ff,
            "num_attention_heads": cfg.n_heads,
            "num_hidden_layers": cfg.n_layers,
            "num_key_value_heads": cfg.n_kv_heads,
            "n_routed_experts": cfg.n_experts,
            "n_shared_experts": cfg.n_shared_experts,
            "num_experts_per_tok": cfg.experts_per_token,
            "kv_lora_rank": cfg.kv_lora_rank,
            "qk_rope_head_dim": cfg.rope_head_dim,
            "qk_nope_head_dim": cfg.head_dim,
            "v_head_dim": cfg.head_dim,
            "rms_norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_embeddings,
            "vocab_size": cfg.vocab_size,
            "hidden_act": cfg.act,
            "rope_scaling": None,
            "first_k_dense_replace": 0,
            "norm_topk_prob": True,
            "q_lora_rank": None}


#: what each family's published keys are in the port's configuration
FAMILY_KEYS = {"llama": _llama_keys, "deepseek_v2": _deepseek_v2_keys}


def implied_keys(cfg, model_type: str) -> Dict:
    """The published keys (and the assumed sparsity) that the port's
    configuration ``cfg`` computes."""
    keys = FAMILY_KEYS[model_type](cfg)
    sp = cfg.ffn_sparsity
    keys["ffn_sparsity"] = {"n": sp.n, "k_frac": sp.k_frac,
                            "route_share": sp.route_share,
                            "kwta": sp.kwta_impl}
    if cfg.is_moe:
        keys["capacity_factor"] = cfg.capacity_factor
    return keys


def mismatches(file: Dict, cfg) -> Dict:
    """{key: (file's value, port's value)} where they differ."""
    out = {}
    for key, port_value in implied_keys(cfg, file["model_type"]).items():
        if key == "ffn_sparsity":
            stated = {k: file["assumed"]["ffn_sparsity"][k]
                      for k in ("n", "k_frac", "route_share", "kwta")}
        elif key == "capacity_factor":
            stated = file["assumed"].get("capacity_factor")
        elif key == "rope_scaling":
            # a group at factor 1 or less is plain RoPE, as the port runs
            stated = file[key]
            if stated is not None and stated["factor"] <= 1:
                stated = None
        else:
            stated = file.get(key)
        if stated != port_value and not (
                isinstance(stated, (int, float))
                and isinstance(port_value, (int, float))
                and not isinstance(stated, bool)
                and float(stated) == float(port_value)):
            out[key] = (stated, port_value)
    return out


def port_config(file: Dict):
    """The port's ``ModelConfig`` that the file describes: its
    configuration ``port.arch`` with the keys of ``FROM_FILE`` set from
    the file; raises where the two still disagree."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(
        get_config(file["port"]["arch"]),
        **{field: file[key] for key, field in FROM_FILE.items()})
    bad = mismatches(file, cfg)
    if bad:
        raise ValueError(f"{file['name']}: the file and the port's "
                         f"configuration differ: {bad}")
    return cfg
