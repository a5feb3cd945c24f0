"""Runnable examples of the port, the counterparts of the repository's
``examples/*.py``: ``python -m repro_torch.examples.<name>`` (on the card
by default, ``--device cpu`` for the plain PyTorch versions).  Each keeps
its reference's published sizes and report, and its ``main(argv)`` takes
smaller sizes from the command line."""
