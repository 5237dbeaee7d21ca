"""Training: the loop, checkpoints, profiling helpers and the CLI."""
