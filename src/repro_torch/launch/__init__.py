"""Serving: the continuous-batching engine and its launcher."""
