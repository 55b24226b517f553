"""k1_roofline: K1's bound over its device time in the window (``harness.readers``)."""
from harness import readers

read = readers.k1_roofline
