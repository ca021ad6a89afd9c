"""Training: the optimizer, the data pipelines, checkpoints, gradient
compression and the train loop (twin of ``repro.train``)."""
