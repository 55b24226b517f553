"""decode_mfu.host: decode_mfu in the chat cells, whose tails are per-layer metrics (``harness.readers``)."""
from harness import readers

read = readers.decode_mfu
