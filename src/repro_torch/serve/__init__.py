from repro_torch.serve.decode import init_decode_state, serve_step  # noqa: F401
