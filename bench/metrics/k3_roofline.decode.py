"""k3_roofline.decode: K3's bound over its device time in the window's decode steps (``harness.readers``)."""
from harness import readers

read = readers.k3_roofline_decode
