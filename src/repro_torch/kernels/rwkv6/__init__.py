"""RWKV6 WKV recurrence: K4 for Hopper, with its plain PyTorch version."""
