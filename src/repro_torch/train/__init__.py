"""Training (step, loop) and fault tolerance of the port."""
