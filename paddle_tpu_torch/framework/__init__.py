"""Framework pieces of the port (device placement)."""
