"""NVIDIA's published peaks of one H100 SXM (dense, no sparsity, at the
card's full 700 W), the yardstick of every share of a peak or a roofline.
A card set below 700 W runs slower; runs print its power limit."""

F32_FLOP_PER_S = 67e12        # float32 on the CUDA cores
TF32_FLOP_PER_S = 495e12      # tf32 on the tensor cores
BF16_FLOP_PER_S = 989e12      # bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float,
            flop_rate: float = F32_FLOP_PER_S) -> float:
    """The least time: the larger of the bytes over the memory's rate and
    the operations over ``flop_rate``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)
