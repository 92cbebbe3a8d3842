from repro_torch.kernels.dp_clip_noise.ops import privatize_flat
