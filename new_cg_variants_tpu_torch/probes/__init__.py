"""Per-iteration probes."""
