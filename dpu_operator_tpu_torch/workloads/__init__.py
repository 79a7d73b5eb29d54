"""Serving compute layer of the port: model, KV-cache decode, KV block
pool and continuous-batching scheduler."""
