"""Published model configurations (the port of ``repro.configs``)."""
