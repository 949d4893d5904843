"""Roofline analysis of the dry run's census — the reference's
``repro.launch.roofline`` with the H100's constants.

Per (arch x shape) cell, three terms of per-rank quantities (the census
counts rank 0's step, :mod:`repro_torch.launch.dryrun`):

    compute    = bf16_FLOPs / PEAK_FLOPS + f32_FLOPs / F32_FLOPS   [s]
    memory     = bytes / HBM_BW                                      [s]
    collective = collective_bytes / NVLINK_BW                        [s]

and the bound is the largest.  The FLOPs are split by operand type
(:mod:`repro_torch.launch.hlo`): bf16 products run on the tensor cores,
everything else (f32 products: the default matmul precision uses no TF32;
elementwise ops) outside them.  The terms read the record's ``full``
census: an eager trace runs every layer, so no loop body is hidden and no
unit is multiplied out (the reference's ``unit``·n_units + ``head`` +
``opt``, kept in the record as a breakdown).  The port traces every cell
at its full sequence length, so the reference's SSM ``scale_T`` correction
is 1 and is dropped.

MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (+ attention KV reads)
for decode, over the ranks of the record's mesh — the "useful" fraction
MODEL_FLOPS / FLOPs exposes dispatch waste.

Hardware constants (NVIDIA H100 SXM5 data sheet): 989 TFLOP/s dense bf16
on the tensor cores, 67 TFLOP/s f32 outside them, 3.35 TB/s HBM3, and
NVLink's 900 GB/s as 450 GB/s each way (the conservative one-link figure,
as the reference takes one ICI link: collective terms are upper bounds).

The bytes are the eager step's (each op's inputs and outputs): the memory
term is an estimate of the eager traffic, not a bound on the work, and it
falls whenever copies and casts are fused away.  Beside it stands a figure
that does not move with the implementation: ``io_memory_s``, the bytes of
the step's arguments (params, cache, inputs) that it reads, read once, of
its writes into them (the cache's new rows) and of its outputs, written
once (the census's ``argument_read_bytes``, ``argument_written_bytes`` and
``output_bytes``), and ``floor_s``, the largest of it, the compute term and
the collective term.  A kernel op's inputs count whole: a sparse-sparse
product whose support touches fewer than all partitions reads less.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

#: dense bf16 tensor-core FLOP/s
PEAK_FLOPS = 989e12
#: f32 FLOP/s outside the tensor cores
F32_FLOPS = 67e12
#: HBM3 bytes/s
HBM_BW = 3.35e12
#: NVLink bytes/s one way
NVLINK_BW = 450e9


def active_params(cfg) -> int:
    """Activated parameters per token (MoE: only top-k experts count)."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    n_mats = 3 if cfg.act == "silu" else 2
    embed = v * d * (1 if cfg.tie_embeddings else 2)
    per_layer = {}
    total = embed
    for kind in cfg.block_pattern:
        if kind in ("attn", "shared_attn"):
            h, hkv, dh = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
            if cfg.use_mla:
                r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
                attn = d * cfg.n_heads * (dh + dr) + d * (r + dr) \
                    + r * 2 * cfg.n_heads * dh + cfg.n_heads * dh * d
            else:
                attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
            if cfg.is_moe and kind == "attn":
                expert = n_mats * d * ff
                active_e = (cfg.experts_per_token
                            + cfg.n_shared_experts) * expert \
                    + d * cfg.n_experts
                ffn = active_e
            else:
                ffn = n_mats * d * ff
                if cfg.ffn_sparsity.weight_sparse:
                    ffn //= cfg.ffn_sparsity.n
            per_layer[kind] = attn + ffn
        elif kind == "mamba2":
            di = cfg.ssm_expand * d
            nh = di // cfg.ssm_head_dim
            per_layer[kind] = d * (2 * di + 2 * cfg.ssm_state + nh) + di * d
        elif kind == "mlstm":
            per_layer[kind] = d * 3 * d + d * 2 * cfg.n_heads + d * d
        elif kind == "slstm":
            dh_ = d // cfg.n_heads
            per_layer[kind] = d * 4 * d + cfg.n_heads * dh_ * 4 * dh_ + d * d
    for kind in cfg.block_pattern:
        total += per_layer[kind] * cfg.n_units
    return int(total)


def kernel_bound(cost) -> Tuple[float, str]:
    """The least time (s) of one kernel call of ``cost`` (a
    :class:`repro_torch.kernels.build.Cost`, from the call's shapes and
    types alone) and what bounds it: its bytes over HBM, or its flops over
    the peak of the cores it runs them on."""
    t_bytes = cost.bytes / HBM_BW
    t_ops = cost.flops / (PEAK_FLOPS if cost.tensor_cores else F32_FLOPS)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _mesh_ranks(mesh: str) -> int:
    """The ranks of a record's mesh, ``"16x16"`` -> 256."""
    n = 1
    for d in mesh.split("x"):
        n *= int(d)
    return n


def cell_roofline(rec: Dict, cfg=None) -> Optional[Dict]:
    """The three terms of one dry-run record (its ``full`` census)."""
    if not rec.get("ok") or "full" not in rec:
        return None
    kind = rec["kind"]
    cost = rec["full"]["cost"]
    flops = cost.get("flops", 0.0)
    bf16 = cost.get("flops_bf16", 0.0)
    f32 = cost.get("flops_f32", flops - bf16)
    bytes_ = cost.get("bytes_accessed", 0.0)
    coll = rec["full"]["collectives"].get("total_bytes", 0.0)

    terms = {"compute_s": bf16 / PEAK_FLOPS + f32 / F32_FLOPS,
             "memory_s": bytes_ / HBM_BW,
             "collective_s": coll / NVLINK_BW}
    bottleneck = max(terms, key=terms.get)
    bound_s = max(terms.values())

    out = {
        "flops_per_chip": flops, "bytes_per_chip": bytes_,
        "collective_bytes_per_chip": coll, **terms,
        "bottleneck": bottleneck.replace("_s", ""),
        "bound_s": bound_s,
    }
    mem = rec["full"].get("memory", {})
    io_keys = ("argument_read_bytes", "argument_written_bytes",
               "output_bytes")
    if all(k in mem for k in io_keys):
        io = sum(mem[k] for k in io_keys)
        out["io_bytes_per_chip"] = io
        out["io_memory_s"] = io / HBM_BW
        out["floor_s"] = max(terms["compute_s"], out["io_memory_s"],
                             terms["collective_s"])
    if cfg is not None:
        n_act = active_params(cfg)
        chips = _mesh_ranks(rec["mesh"])
        if kind == "train":
            tokens = rec["global_batch"] * rec["seq_len"]
            model_flops = 6 * n_act * tokens / chips
        elif kind == "prefill":
            tokens = rec["global_batch"] * rec["seq_len"]
            model_flops = 2 * n_act * tokens / chips
        else:  # decode: one token per sequence + KV attention reads
            model_flops = 2 * n_act * rec["global_batch"] / chips
            if not cfg.supports_long_context or any(
                    k.startswith("attn") or k == "shared_attn"
                    for k in cfg.block_pattern):
                n_attn = sum(1 for k in cfg.block_pattern
                             if k in ("attn", "shared_attn")) * rec["n_units"]
                kv_flops = (2 * 2 * rec["global_batch"] * rec["seq_len"]
                            * cfg.n_kv_heads * cfg.head_dim * n_attn)
                model_flops += kv_flops / chips
        out["model_flops_per_chip"] = model_flops
        out["useful_fraction"] = model_flops / flops if flops else 0.0
        out["mfu_at_bound"] = (model_flops / PEAK_FLOPS) / bound_s \
            if bound_s else 0.0
    return out


SUGGESTIONS = {
    ("train", "compute"): "cut FLOPs: larger CS pack factor N on FFNs, "
                          "fewer remat recomputes (selective policies), or "
                          "offload head matmul to lower-precision",
    ("train", "memory"): "cut bytes: bf16 master/moments, fuse the routed "
                         "gather (CUDA grouped kernel), larger flash "
                         "blocks to amortize HBM traffic",
    ("train", "collective"): "cut collective bytes: reduce-scatter instead "
                             "of all-reduce+slice (ZeRO), overlap grad sync "
                             "with backward, int8 gradient compression "
                             "across pods",
    ("prefill", "compute"): "attention dominates at 32k: larger flash "
                            "blocks, CS-pack projections",
    ("prefill", "memory"): "keep qkv in bf16 end-to-end; avoid f32 "
                           "score materialization",
    ("prefill", "collective"): "shard sequence (SP) to shrink per-chip "
                               "activations before TP collectives",
    ("decode", "compute"): "decode is rarely compute-bound; if so, the "
                           "sparse-sparse topk path (B*K < D_in) cuts MACs",
    ("decode", "memory"): "weight + KV bytes dominate: CS packing gives "
                          "~N x on weights; quantize KV cache to int8; "
                          "MLA-style latent caches",
    ("decode", "collective"): "replicate small weights instead of TP "
                              "all-gathers; batch multiple tokens per step",
}


def analyze(results_path: str = "experiments/dryrun_results_torch.json",
            out_path: str = "experiments/roofline_torch.json") -> Dict:
    from repro_torch.configs import get_config
    with open(results_path) as f:
        results = json.load(f)
    table = {}
    for key, rec in results.items():
        parts = key.split("|")
        if len(parts) != 3:
            continue  # tagged variants live in their own file
        arch, shape, mesh = parts
        if mesh != "pod1" or not rec.get("ok"):
            continue
        try:
            cfg = get_config(arch)
        except KeyError:
            cfg = None
        rl = cell_roofline(rec, cfg)
        if rl is None:
            continue
        rl["suggestion"] = SUGGESTIONS.get(
            (rec["kind"], rl["bottleneck"]), "")
        rl["peak_bytes_per_device"] = rec["full"]["memory"].get(
            "peak_bytes_est")
        table[f"{arch}|{shape}"] = rl
    with open(out_path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    return table


def to_markdown(table: Dict) -> str:
    lines = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
        "bottleneck | model GFLOP/chip | useful frac | MFU@bound | "
        "mem/dev (GB) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(table):
        r = table[key]
        arch, shape = key.split("|")
        lines.append(
            f"| {arch} | {shape} | {r['compute_s']*1e3:.2f} | "
            f"{r['memory_s']*1e3:.2f} | {r['collective_s']*1e3:.2f} | "
            f"**{r['bottleneck']}** | "
            f"{r.get('model_flops_per_chip', 0)/1e9:.1f} | "
            f"{r.get('useful_fraction', 0):.2f} | "
            f"{r.get('mfu_at_bound', 0)*100:.1f}% | "
            f"{(r.get('peak_bytes_per_device') or 0)/1e9:.1f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(to_markdown(analyze()))
