"""Parameter definitions for one card (the reference's logical-axis
sharding rules wait for the multi-card slices)."""
