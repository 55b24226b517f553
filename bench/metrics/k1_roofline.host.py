"""k1_roofline.host: k1_roofline in the chat cells, whose tails are per-layer metrics (``harness.readers``)."""
from harness import readers

read = readers.k1_roofline
