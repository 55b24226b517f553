"""decode_step_ms: the window's time outside admissions and sleeps per decode step (``harness.readers``)."""
from harness import readers

read = readers.decode_step_ms
