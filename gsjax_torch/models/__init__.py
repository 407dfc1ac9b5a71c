"""Fixed-capacity Gaussian scene state."""
