"""Hand-written Hopper kernels of the port, one folder per kernel family
(``kernel.py`` builds and launches, ``ref.py`` is the plain PyTorch
version, ``ops.py`` dispatches by the tensor's device)."""
