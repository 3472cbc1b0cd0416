"""Data parallelism over the env axis: `distributed` (the process group)
and `sharding` (the rank's env block and the collectives)."""
