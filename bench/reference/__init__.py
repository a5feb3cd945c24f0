"""Plain references of the benchmark's configurations (plain PyTorch;
nothing of the port, nothing the port made)."""
