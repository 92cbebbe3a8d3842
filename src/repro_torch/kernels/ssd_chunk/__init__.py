from repro_torch.kernels.ssd_chunk.ops import ssd_chunked_fused, ssd_intra_chunk
