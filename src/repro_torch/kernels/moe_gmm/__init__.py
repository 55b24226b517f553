"""MoE grouped matmul: K3 for Hopper, with its plain PyTorch version."""
