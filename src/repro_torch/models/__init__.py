"""Models ported from ``repro.models``: the vision models of the paper's
experiments and the homogeneous decoder-only transformer."""
