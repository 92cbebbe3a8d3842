from repro_torch.serving.engine import ServeEngine, build_decode_step
