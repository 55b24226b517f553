"""admit_ms_per_ktok: wall of the window's admissions per 1,000 prompt tokens admitted (``harness.readers``)."""
from harness import readers

read = readers.admit_ms_per_ktok
