"""tpot_p90_s: 90th percentile time per output token over the requests with 2 or more tokens in the window (``harness.readers``)."""
from harness import readers

read = readers.tpot_p90
