"""Weight bridge: the reference's params pytree, as numpy, to the port's
params.

The caller converts the JAX pytree first (``jax.tree.map(np.asarray,
params)``), so this module needs no JAX.  The leaves keep their layout —
``packed`` (G, P, N), int8 ``route`` (G/R, P, N), dense ``w`` (D_in,
D_out), tables (vocab, d) — and the stacked ``units`` axis is split into
the port's per-layer list (layer ``u·L + i`` is ``units["b{i}"][u]``).
MLA's bare weights and the MoE leaves (router, stacked experts, shared
experts) come across as they are.  Each packed linear layer (G, P, N)
gains its partition-major copy; the routed experts' (E, G, P, N) do not
(they never reach ``topk_gather``, and a copy would double the experts'
bytes).  Every weight is cast to the compute dtype, as
:func:`repro_torch.models.transformer.init_model` does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.layers import partition_major
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import check_supported, prepare_params


def _tensors(tree, device):
    """numpy leaves -> tensors on ``device``; packed linear layers (G, P, N)
    gain packed_p, stacked experts (E, G, P, N) do not."""
    if isinstance(tree, dict):
        out = {k: _tensors(v, device) for k, v in tree.items()}
        if "packed" in out and out["packed"].ndim == 3:
            out["packed_p"] = partition_major(out["packed"])
        return out
    if isinstance(tree, list):
        return [_tensors(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def _unit_slice(tree, u: int):
    if isinstance(tree, dict):
        return {k: _unit_slice(v, u) for k, v in tree.items()}
    return tree[u]


def params_from_jax(params: Dict, cfg, device=None) -> Dict:
    """Port params from the reference's ``init_model`` params (numpy
    leaves).  Runs on ``cuda`` unless ``device`` says otherwise."""
    check_supported(cfg)
    device = resolve_device(device)
    units = params["units"]
    layers = [_unit_slice(units[f"b{i}"], u)
              for u in range(cfg.n_units)
              for i in range(len(cfg.block_pattern))]
    out = {"embed": params["embed"], "layers": layers,
           "final_norm": params["final_norm"]}
    if "head" in params:
        out["head"] = params["head"]
    return prepare_params(_tensors(out, device), cfg)

