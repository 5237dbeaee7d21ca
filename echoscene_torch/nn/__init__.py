"""Neural network modules of the port (PyTorch, channel-first inside)."""
