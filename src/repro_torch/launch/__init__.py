"""Step builders, meshes and the dry run (twin of ``repro.launch``)."""
