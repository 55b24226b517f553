"""k2_roofline: K2's bound over its device time in the window's admissions (``harness.readers``)."""
from harness import readers

read = readers.k2_roofline
