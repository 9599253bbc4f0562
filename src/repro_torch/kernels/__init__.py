"""The kernels: hand-written CUDA (``csrc/``), their plain torch
versions, the wrappers the model calls (``ops``), and the block-shape
autotuner (``autotune``) whose winners, swept on the card and shipped in
``pretuned.json``, pick each kernel's launch knob."""
