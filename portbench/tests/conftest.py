"""The benchmark's tests: ``python -m pytest portbench/tests -q`` from the
repository's root. Tests marked ``cuda`` run on a card and skip without
one."""

import os
import sys

# the repository's root, so that ``portbench`` and ``ich_tpu_torch`` import
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
