"""PyTorch and CUDA port of the SVFusion engine (``src/repro`` is the JAX
reference it is held against)."""
