"""Training-side utilities of the port (``checkpoint``: the atomic
checkpoint manager the serving snapshots ride)."""
