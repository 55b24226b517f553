"""tpot_p90_s.host: 90th percentile time per output token over the untraced part of the window (``harness.readers``)."""
from harness import readers

read = readers.tpot_p90_host
