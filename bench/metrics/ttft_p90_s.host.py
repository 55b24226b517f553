"""ttft_p90_s.host: 90th percentile time to first token of the requests due in the untraced part of the window (``harness.readers``)."""
from harness import readers

read = readers.ttft_p90_host
