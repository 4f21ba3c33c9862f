"""The paper's layered CNNs in PyTorch."""
