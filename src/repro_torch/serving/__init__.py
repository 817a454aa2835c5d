"""Serving of the port: the batched engine (one replica)."""
