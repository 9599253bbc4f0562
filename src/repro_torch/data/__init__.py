"""Deterministic synthetic LM data."""
