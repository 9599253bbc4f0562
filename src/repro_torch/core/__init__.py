"""Formats, precision policies and the transprecision ops (torch)."""
