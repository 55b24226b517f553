"""decode_device_ms.host: decode_device_ms in the chat cells, whose tails are per-layer metrics (``harness.readers``)."""
from harness import readers

read = readers.decode_device_ms
