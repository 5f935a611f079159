"""Observability: the outcome vocabulary, the disabled telemetry hub and
the streaming sketches the v5 trace rounds use."""
