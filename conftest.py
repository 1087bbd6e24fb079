"""Load ``tests/suite_clock.py`` before ``tests/conftest.py`` imports torch.

pytest reads this file first for every test under the repo; the plugin caps
each xdist worker's threads and gives every test a time limit.
"""

import sys
from pathlib import Path

sys.path.append(str(Path(__file__).parent / "tests"))
pytest_plugins = ("suite_clock",)
