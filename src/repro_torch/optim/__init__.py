"""Transprecision optimizers (the JAX package's ``optim``)."""
