"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the
700 W limit), frozen from ``repro_torch.launch.roofline``'s constants."""

#: dense bf16 tensor-core FLOP/s
BF16_FLOPS = 989e12
#: float32 FLOP/s outside the tensor cores
F32_FLOPS = 67e12
#: HBM3 bytes/s
HBM_BYTES = 3.35e12


def kernel_bound_s(flops: float, nbytes: float, tensor_cores: bool) -> float:
    """The least time of one kernel call: the larger of its bytes over HBM
    and its flops over the peak of the cores it runs them on (frozen from
    ``repro_torch.launch.roofline.kernel_bound``)."""
    return max(nbytes / HBM_BYTES,
               flops / (BF16_FLOPS if tensor_cores else F32_FLOPS))
