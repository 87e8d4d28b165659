"""The benchmark's own tests (CPU; those marked ``cuda`` decide inside the
test whether a card exists).  Run from the repository's root:

    python -m pytest bench_port/tests -q
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
