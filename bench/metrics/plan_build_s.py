"""plan_build_s: trace + plan + build of the Tessera executable, inside set-up (``harness.readers``)."""
from harness import readers

read = readers.extra('plan_build_s')
