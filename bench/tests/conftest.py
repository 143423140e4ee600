"""The benchmark's tests: its harness and the program's sources on the
path, as `bench/run.py` puts them.  Run from the repository's root:

    python -m pytest -q bench/tests            # on the host
    python -m pytest -q -m cuda bench/tests    # on the card
"""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH.parent / "src", BENCH):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
