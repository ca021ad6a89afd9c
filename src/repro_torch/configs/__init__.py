"""Model and shape configurations (twin of ``repro.configs``): one module
per architecture with ``CONFIG`` and ``smoke_config()``."""
