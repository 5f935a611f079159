"""Observability: the outcome vocabulary and the disabled telemetry hub."""
