"""LM building blocks and model assembly for every family, with the
training loss and the remat policies (twin of ``repro.models``)."""
