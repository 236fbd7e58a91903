"""Fixtures of the benchmark's CPU tests.

Run from the checkout's root:  python -m pytest perfbench/tests
(with ``-n 4``, give each worker a share of the cores, such as
``OMP_NUM_THREADS=2``: more threads than cores slow the fits a
hundredfold).
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def tiny_cell(tmp_path):
    from perfbench import harness
    from perfbench.tests.tiny import write_cell
    return harness.load_cell("tiny.fit", write_cell(tmp_path), tmp_path)
