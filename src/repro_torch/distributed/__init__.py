"""Distribution of the port (``sharding``: the partition rules of every
architecture, and placing a tree on a one-device mesh)."""
