"""Multi-process runs of the drivers (one process per card)."""
