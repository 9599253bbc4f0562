"""Atomic, async checkpoints in the JAX package's file format."""
