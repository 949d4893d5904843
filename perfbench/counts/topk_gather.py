"""The work of one ``topk_gather`` launch, frozen from
``repro_torch.kernels.topk_gather.cost``: 2·B·K·G·N flops on the CUDA
cores (each entry times its partition's row of G·N weights, the route's
mask included), and the bytes of the support, of the packed and route rows
of every partition the support can touch (min(B·K, P)) and of the
output."""

TENSOR_CORES = False


def cost(b: int, k: int, p: int, g: int, n: int, r: int, vals_bytes: int,
         idx_bytes: int, w_bytes: int, out_bytes: int):
    """(flops, bytes) of one launch."""
    rows = min(b * k, p)
    flops = 2 * b * k * g * n
    nbytes = (b * k * (vals_bytes + 2 * idx_bytes)
              + rows * (g * n * w_bytes + g // r * n)
              + b * g * n * out_bytes)
    return flops, nbytes


def launch_shape(cfg, slots: int):
    """The shape of the decode step's launch: the FFN's (or the shared
    experts') down projection at ``slots`` rows, bf16 values and weights,
    int64 indices, a bf16 output, all groups on one route table."""
    sp = cfg.ffn_sparsity
    d_in = cfg.d_ff * (cfg.n_shared_experts if cfg.is_moe else 1)
    n = sp.n
    g = cfg.d_model // n
    r = g if sp.route_share == 0 else sp.route_share
    return dict(b=slots, k=sp.k_for(d_in), p=d_in // n, g=g, n=n, r=r,
                vals_bytes=2, idx_bytes=8, w_bytes=2, out_bytes=2)
