"""Data pipelines of the port (``speech``: the synthetic speech-feature
stream the launcher's demo clients send)."""
