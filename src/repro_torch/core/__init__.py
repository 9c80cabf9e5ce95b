"""Serving substrate: object store, directory, cache, FaaS runtime, gateway."""
