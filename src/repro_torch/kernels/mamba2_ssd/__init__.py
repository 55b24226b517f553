"""Mamba2 SSD chunked scan: K5 for Hopper, with its plain PyTorch
version."""
