"""Parameter definitions for one card, and the wave mesh's placement
(:func:`~repro_torch.parallel.sharding.wave_sharding`) and host gather
(:func:`~repro_torch.parallel.collectives.gather_shards`); the reference's
logical-axis sharding rules wait for the port's training loop."""
