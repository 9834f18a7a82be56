"""Host-side utilities: the env registry, rank-aware logging and device
selection."""
