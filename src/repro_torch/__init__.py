"""PyTorch port of the sparse-sparse system (``repro``), for an NVIDIA
Hopper GPU: serving and training.

It mirrors the reference package's layout (``configs``, ``core``,
``kernels``, ``models``, ``runtime``, ``launch``, ``data``, ``optim``,
``checkpoint``) and imports neither JAX nor the reference.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; there the CUDA
kernels' plain PyTorch versions run.
"""
