"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a tiny
size, run on the CPU's plain tier.

    python -m pytest bench_torch/tests -q
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ["northstar.train", "longpath.scoring", "northstar.gram",
         "longpath.chsic"]
# each mix's batches at the tiny size
TINY_PATHS = {"lincomb_train": {"X": 3, "Y": 4},
              "scoring_train": {"X": 4, "y": 1},
              "gram_sym": {"X": 4}, "chsic": {"X": 5, "Y": 5, "Z": 5}}


def shrink(root: Path, length=8, dim=2):
    """Cut every configuration to ``length`` points of ``dim`` and every
    mix to :data:`TINY_PATHS`, in the copy under ``root``."""
    for p in (root / "bench_torch" / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        d.update(length=length, dim=dim)
        p.write_text(json.dumps(d))
    for name, paths in TINY_PATHS.items():
        p = root / "bench_torch" / "traffic" / f"{name}.json"
        d = json.loads(p.read_text())
        d["paths"] = paths
        p.write_text(json.dumps(d))


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout of the benchmark alone, cut to a tiny size."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_torch", tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(tmp_path)
    return tmp_path
