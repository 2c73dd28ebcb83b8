"""The benchmark's own tests, run from the root of a checkout:

    python -m pytest perfbench/tests -q

They hold the reference and the frozen scene builders to the program on
the CPU at small sizes, the frozen yardstick to the program's reckonings,
and the comparison that decides ``correct`` against its control and its
faults. Tests marked ``gpu`` need a CUDA card and skip without one."""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(2)
