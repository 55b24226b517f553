"""dispatch_units: dispatch units of the Tessera executable serving the cell (``harness.readers``)."""
from harness import readers

read = readers.extra('dispatch_units')
