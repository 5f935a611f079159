"""Federated runtime: data partitioning, network and failure models, the
scenario worlds and timing engine, the round runner, the communication
codecs and the server loops."""
