"""Vision models of the paper's experiments, ported from ``repro.models``."""
