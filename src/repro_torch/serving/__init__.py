"""Serving of the port: the continuous-batching engine over a paged KV pool."""
