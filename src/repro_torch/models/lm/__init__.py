"""The LM model zoo in PyTorch: the dense and zamba families behind the
``LayerStack`` protocol (the port of ``repro.models.lm``)."""
