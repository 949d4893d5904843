"""The shape sweeps of the reference's kernel registry
(``repro/kernels/registry.py``), as plain data.

Each tuple is one configuration the reference proves clean; they bracket
the regimes the serving and training paths use (single-tile grids,
multi-step accumulation, batched decode).  The block sizes are the
reference's TPU tiles: the port's kernels take none and mask their edges,
so they are kept only so that the tuples read as the reference's.  The CPU
tests and ``chip_smoke.py`` run every kernel at these shapes.
"""

#: topk_gather_matmul: (b, k_nnz, p, g, n, block_g)
TOPK_GATHER_SWEEP = (
    (4, 16, 32, 8, 4, 8),
    (8, 32, 64, 16, 4, 8),
    (2, 8, 16, 4, 4, 2),
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
