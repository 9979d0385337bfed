"""Serving engine of the port: paged KV pool, paged programs, ContinuousBatcher."""
