"""The attention kernels: hand-written CUDA (``csrc/``), their plain
torch versions, and the wrappers the model calls."""
