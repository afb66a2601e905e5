from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
