"""The benchmark's own tests: `python -m pytest portbench/tests`. Tests
that need the card are marked `card` and skip without one."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")
