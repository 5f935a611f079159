from repro_torch.checkpoint.io import load, save  # noqa: F401
