"""decode_device_ms: device-busy ms per decode step in the traced window (``harness.readers``)."""
from harness import readers

read = readers.decode_device_ms
