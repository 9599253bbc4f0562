"""Model pieces: layers, paged KV cache, attention, the transformer."""
