"""Plain data types and schedule tables of the port."""
