"""Per-iteration probes."""

from .probes import DEFAULT_PROBES, PROBES, resolve_probes
