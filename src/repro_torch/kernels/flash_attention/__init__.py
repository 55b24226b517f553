"""Flash attention: K1 (decode) and K2 (prefill) for Hopper, with their
plain PyTorch versions."""
