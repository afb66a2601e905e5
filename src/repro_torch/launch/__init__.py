"""Entry points and launch helpers of the port: ``python -m
repro_torch.launch.serve``, the wave mesh of sharded waves
(:mod:`repro_torch.launch.mesh`) and the elastic worker pool
(:mod:`repro_torch.launch.elastic`)."""
