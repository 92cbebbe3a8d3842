from repro_torch.kernels.fedavg_agg.ops import aggregate_flat, aggregate_pytrees
