"""device_idle_share.host: device_idle_share in the chat cells, whose tails are per-layer metrics (``harness.readers``)."""
from harness import readers

read = readers.device_idle_share
