"""Model configurations of the port (``spartus_lstm``: Table II)."""
