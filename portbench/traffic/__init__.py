"""Traffic generators, one module a kind, each with ``run(cell) -> dict``."""
