"""Launchers of the port (``serve``: the asyncio streaming server over
TCP/JSON lines)."""
