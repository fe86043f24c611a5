"""The benchmark's tests: the repository's root on the path, so that
``perfbench`` and the program import as the benchmark's runs import them."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
