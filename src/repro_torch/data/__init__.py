"""Synthetic datasets (numpy), copied from ``repro.data``."""
