"""PyTorch port of the sparse-sparse serving system (``repro``), for an
NVIDIA Hopper GPU.

It mirrors the reference package's layout (``configs``, ``core``,
``kernels``, ``models``, ``runtime``, ``launch``) and imports neither JAX
nor the reference.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; there the CUDA kernels' plain PyTorch versions run.
"""
