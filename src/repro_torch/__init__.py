"""FedCCL in PyTorch for NVIDIA Hopper GPUs.

A port of the JAX package ``repro`` (which stays the reference).  Parameter
trees are nested dicts of tensors with the reference's key names; the
server fold, the LSTM scans (forward and backward), the anchor update and
the DP clip + noise release run as hand-written CUDA kernels on CUDA tensors and as their
plain PyTorch versions on CPU tensors (``repro_torch.kernels``).  Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""
