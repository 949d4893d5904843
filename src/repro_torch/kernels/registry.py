"""The shape sweeps of the reference's kernel registry
(``repro/kernels/registry.py``), as plain data, and the port's serving
shapes that the reference's sweeps lack.

Each of the reference's tuples is one configuration it proves clean; they
bracket the regimes the serving and training paths use (single-tile
grids, multi-step accumulation, batched decode).  ``TOPK_GATHER_SWEEP``
adds, after them, the decode down projections at 4 slots of
deepseek-v2-lite-16b's shared experts and of zamba2-1.2b's shared
attention block.  The block sizes are the
reference's TPU tiles: the port's kernels take none and mask their edges,
so they are kept only so that the tuples read as the reference's.  The CPU
tests, ``chip_smoke.py`` and the linter's kernel checks
(``repro_torch.analysis.lint_kernels``) run every kernel at these shapes.

:data:`OPERAND_DTYPES` holds the types each kernel's custom op declares
for its tensor operands, in order, for the linter's ``dtype-promotion``
rule.
"""

import torch

_FLOATS = (torch.float32, torch.bfloat16)
_INDICES = (torch.int32, torch.int64)

#: custom op -> the types each tensor operand may take, in order
OPERAND_DTYPES = {
    "repro_torch.topk_gather": (_FLOATS, _INDICES, _INDICES, _FLOATS,
                                (torch.int8,)),
    "repro_torch.packed_matmul": (_FLOATS, _FLOATS, (torch.int8,)),
    "repro_torch.grouped_cs_matmul": (_FLOATS, _FLOATS),
    "repro_torch.kwta_hist": (_FLOATS,),
}

#: topk_gather_matmul: (b, k_nnz, p, g, n, block_g)
TOPK_GATHER_SWEEP = (
    (4, 16, 32, 8, 4, 8),
    (8, 32, 64, 16, 4, 8),
    (2, 8, 16, 4, 4, 2),
    # deepseek-v2-lite-16b's shared experts (d_ff 2·1408 = 2816 -> 2048):
    # B=4 slots, K=k_for(2816)=352, P=2816/4, G=2048/4, N=4
    (4, 352, 704, 512, 4, 128),
    # zamba2-1.2b's shared block (d_ff 8192 -> 2048, gelu): B=4 slots,
    # K=k_for(8192)=1024, P=8192/4, G=2048/4, N=4
    (4, 1024, 2048, 512, 4, 128),
)

#: grouped_cs_matmul: (n, b, p, g, block_b, block_p, block_g)
GROUPED_CS_SWEEP = (
    (4, 8, 16, 8, 128, 256, 256),
    (4, 16, 64, 32, 8, 16, 16),
    (2, 128, 256, 128, 64, 64, 64),
)

#: packed_matmul: (b, p, g, n, block_b, block_p, block_g)
PACKED_MATMUL_SWEEP = (
    (8, 8, 8, 4, 128, 64, 64),
    (16, 32, 32, 4, 8, 8, 16),
    (128, 64, 64, 8, 64, 32, 32),
)

#: kwta_hist_pallas: (b, d, k, block_b)
KWTA_HIST_SWEEP = (
    (8, 64, 8, 8),
    (16, 128, 16, 4),
)
