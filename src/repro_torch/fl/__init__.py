"""Federated runtime: data partitioning, network and failure models, the
round runner, the communication codecs and the server loops."""
