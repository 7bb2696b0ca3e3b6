"""The benchmark's own tests (`python -m pytest benchmark/tests`): the
harness, the generator, the plain reference and its control, on the CPU
at small sizes."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
