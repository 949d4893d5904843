"""Weight bridge: the reference's params pytree, as numpy, to the port's
params.

The caller converts the JAX pytree first (``jax.tree.map(np.asarray,
params)``), so this module needs no JAX.  The leaves keep their layout —
``packed`` (G, P, N), int8 ``route`` (G/R, P, N), dense ``w`` (D_in,
D_out), tables (vocab, d) — and the stacked ``units`` axis is split into
the port's per-layer list (layer ``u·L + i`` is ``units["b{i}"][u]``; a
``shared_attn`` layer is an empty dict, its weights the reference's
``shared`` subtree, carried over once).  MLA's bare weights, the MoE
leaves (router, stacked experts, shared experts) and the SSM mixers'
leaves come across as they are.  Each packed linear layer (G, P, N)
gains its partition-major copy; the routed experts' (E, G, P, N) do not
(they never reach ``topk_gather``, and a copy would double the experts'
bytes).  Every weight is cast to the compute dtype, as
:func:`repro_torch.models.transformer.init_model` does.

:func:`train_params_from_jax` makes the training layout instead (float
leaves in ``param_dtype``, no partition-major copies),
:func:`gsc_params_from_jax` the GSC CNN's tree, and
:func:`packed_params_from_jax` any tree of packed linear layers
(``repro.core.layers.packed_linear_init``'s params, as the quickstart's
MLP holds them).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.layers import add_partition_major
from repro_torch.models.common import dtype_of, resolve_device
from repro_torch.models.transformer import (check_supported, layer_kinds,
                                            prepare_params)
from repro_torch.tree import map_tree


def _tensors(tree, device):
    """numpy leaves -> tensors on ``device``, in the same structure."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def _unit_slice(tree, u: int):
    if isinstance(tree, dict):
        return {k: _unit_slice(v, u) for k, v in tree.items()}
    return tree[u]


def _layers(params: Dict, cfg) -> Dict:
    """The reference's tree with its stacked ``units`` split into the
    port's per-layer list (numpy leaves)."""
    check_supported(cfg)
    units, n = params["units"], len(cfg.block_pattern)
    layers = [{} if kind == "shared_attn" else
              _unit_slice(units[f"b{j % n}"], j // n)
              for j, kind in enumerate(layer_kinds(cfg))]
    out = {"embed": params["embed"], "layers": layers,
           "final_norm": params["final_norm"]}
    for key in ("shared", "head"):
        if key in params:
            out[key] = params[key]
    return out


def params_from_jax(params: Dict, cfg, device=None) -> Dict:
    """Port serving params from the reference's ``init_model`` params
    (numpy leaves): packed linear layers gain ``packed_p``, weights are
    cast to the compute dtype.  Runs on ``cuda`` unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    out = _tensors(_layers(params, cfg), device)
    return prepare_params(add_partition_major(out), cfg)


def train_params_from_jax(params: Dict, cfg, device=None) -> Dict:
    """Port params in the training layout (float leaves in
    ``param_dtype``, no ``packed_p``), leaf for leaf the reference's, so a
    JAX grads tree converted by this function compares with the port's
    grads leaf by leaf.  Runs on ``cuda`` unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    pt = dtype_of(cfg.param_dtype)
    return map_tree(lambda t: t.to(pt) if t.is_floating_point() else t,
                    _tensors(_layers(params, cfg), device))


def gsc_params_from_jax(params: Dict, device=None) -> Dict:
    """The GSC CNN's params (``conv1``, ``conv2``, ``linear``, ``out``;
    numpy leaves of ``repro.models.gsc_cnn.init_model``) as the port's
    :mod:`repro_torch.models.gsc_cnn` holds them: the same leaves, no
    ``packed_p``.  Runs on ``cuda`` unless ``device`` says otherwise."""
    device = resolve_device(device)
    return _tensors({k: params[k] for k in ("conv1", "conv2", "linear",
                                            "out")}, device)


def packed_params_from_jax(params: Dict, device=None) -> Dict:
    """A tree of packed linear layers (each ``{"packed", "route"[, "b"]}``
    of ``repro.core.layers.packed_linear_init``; numpy leaves) as
    :func:`repro_torch.core.layers.packed_linear_apply` takes them: the
    same leaves, in the training layout (no ``packed_p``;
    :func:`repro_torch.core.layers.add_partition_major` makes the serving
    copies).  Runs on ``cuda`` unless ``device`` says otherwise."""
    return _tensors(params, resolve_device(device))
