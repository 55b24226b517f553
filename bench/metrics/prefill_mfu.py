"""prefill_mfu: model FLOPs of the window's admitted prompts over the admissions' wall at the bf16 peak (``harness.readers``)."""
from harness import readers

read = readers.prefill_mfu
