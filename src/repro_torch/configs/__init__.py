"""Model configurations of the ported archs, one module each."""
