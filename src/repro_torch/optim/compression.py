"""Int8 error-feedback gradient compression: the per-tensor quantizer and
the residual state of the reference's ``repro.optim.compression``.

Quantize (grad + residual) to int8 with a per-tensor scale, dequantize,
average the dequantized values over the ``pod`` axis, and carry the
quantization error into the next step's residual: the *accumulated*
update is unbiased.  As in the reference, the values summed are the
dequantized float32 ones (each pod has its own scale, so int8 sums alone
could not give them); the collective is one ``all_reduce`` over the pod
group for the whole tree (:mod:`repro_torch.sharding.collectives`).

Composition contract: the grads enter fully reduced *within* each pod;
the residuals are per-pod state, the reference's ``(n_pods, ...)`` leaves
sharded over ``pod``, of which a rank holds its block (leading dim 1).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.sharding.collectives import all_reduce_, summed
from repro_torch.tree import is_float, leaves, map_tree, unflatten


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    x32 = x.float()
    amax = x32.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    # round half to even, as jnp.round
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _ef_quantize(g: torch.Tensor, resid: torch.Tensor):
    """(sent, new_resid): grad + residual through int8 and back, and the
    error that stays behind."""
    comp_in = g.float() + resid
    q, scale = quantize_int8(comp_in)
    sent = dequantize_int8(q, scale)
    return sent, comp_in - sent


def _ef_psum_leaf(g: torch.Tensor, resid: torch.Tensor, group,
                  n_pods: int):
    """One leaf's pod mean with error feedback: returns (the mean of the
    pods' dequantized grads in ``g``'s dtype, the new residual).  ``group``
    is the pod group (None for one pod); int leaves pass through."""
    if not is_float(g):
        return g, resid
    sent, new_resid = _ef_quantize(g, resid)
    g_sum = all_reduce_(sent, group)
    return (g_sum / n_pods).to(g.dtype), new_resid


def make_compressed_grad_sync(mesh, axis: str = "pod"):
    """Returns ``sync(grads, resids) -> (synced, new_resids)``: the mean
    over the ``axis`` group of every float leaf, each pod's leaf sent as
    int8 with error feedback (:func:`_ef_psum_leaf`, all leaves in one
    ``all_reduce``).  ``grads`` are this rank's (its pod's) grads;
    ``resids`` its block of :func:`init_residuals`' tree (leading dim 1,
    e.g. ``init_residuals(grads, 1)``)."""
    n_pods = mesh.shape[axis]
    group = mesh.group(axis)

    def sync(grads, resids):
        flat_g, flat_r = leaves(grads), leaves(resids)
        floats = [i for i, g in enumerate(flat_g) if is_float(g)]
        quantized = {i: _ef_quantize(flat_g[i], flat_r[i][0]) for i in floats}
        bufs = summed([tuple(flat_g[i].shape) for i in floats],
                      lambda j, buf: buf.copy_(quantized[floats[j]][0]),
                      group, flat_g[floats[0]].device) if floats else []
        out_g, out_r = list(flat_g), list(flat_r)
        for i, buf in zip(floats, bufs):
            out_g[i] = (buf / n_pods).to(flat_g[i].dtype)
            out_r[i] = quantized[i][1][None]
        return unflatten(grads, out_g), unflatten(resids, out_r)

    return sync


def init_residuals(grads_like, n_pods: int):
    """Per-pod residual state: leading dim n_pods, float32 for float
    leaves, an int32 ``(n_pods,)`` placeholder for int leaves."""
    return map_tree(
        lambda g: torch.zeros((n_pods, *g.shape), dtype=torch.float32,
                              device=g.device) if is_float(g)
        else torch.zeros((n_pods,), dtype=torch.int32, device=g.device),
        grads_like)
