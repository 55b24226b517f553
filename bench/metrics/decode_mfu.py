"""decode_mfu: model FLOPs of the window's decode steps over their time at the bf16 peak (``harness.readers``)."""
from harness import readers

read = readers.decode_mfu
