"""Launch drivers, ported from ``repro/launch``."""
