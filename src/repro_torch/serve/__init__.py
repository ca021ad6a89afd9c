"""LM serving: continuous batching and retrieval-augmented serving over
the live index (twin of ``repro.serve``)."""
