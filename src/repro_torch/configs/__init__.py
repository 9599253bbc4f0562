"""Model configurations (gemma2-9b only in this port)."""
