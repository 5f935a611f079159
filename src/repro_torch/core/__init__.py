"""Aggregation weights, pytree aggregation and strategies."""
