"""Functional core of the port: index state, search, build, placement,
serving."""
