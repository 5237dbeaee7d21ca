"""Model facade and configuration of the port."""
