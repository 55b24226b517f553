"""k3_roofline.prefill.offline: K3's bound over its device time in the window's admissions (``harness.readers``)."""
from harness import readers

read = readers.k3_roofline_prefill
