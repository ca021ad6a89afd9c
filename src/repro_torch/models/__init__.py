"""LM building blocks and model assembly (twin of ``repro.models``; the
dense family)."""
