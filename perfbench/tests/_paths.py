"""Puts the checkout's root and ``src`` on ``sys.path`` for the
benchmark's tests (they run outside the repository's ``tests/``)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
