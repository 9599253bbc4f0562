"""Fault tolerance of the port (serving side)."""
