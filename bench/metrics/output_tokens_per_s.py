"""output_tokens_per_s: output tokens that reached the host in the window, per second (``harness.readers``)."""
from harness import readers

read = readers.output_tokens_per_s
