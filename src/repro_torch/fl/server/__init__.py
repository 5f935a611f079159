"""Server round loops."""
