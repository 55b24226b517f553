"""device_idle_share: share of the window with no device activity (``harness.readers``)."""
from harness import readers

read = readers.device_idle_share
