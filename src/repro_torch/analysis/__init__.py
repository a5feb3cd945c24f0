"""Concurrency tooling of the port (``lockorder``: the runtime
lock-order recorder and lock factory)."""
