"""Data parallelism over several devices: one process per device for
training (`torch.distributed`), one process with one replica per device for
generation."""
