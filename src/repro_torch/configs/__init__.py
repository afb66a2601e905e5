"""One module per assigned architecture (+ the paper's own workload).

Use :func:`repro_torch.config.get_config` to resolve ``--arch`` ids.
"""
