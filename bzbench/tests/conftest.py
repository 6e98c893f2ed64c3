"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout, with a small configuration and traffic of its own.

Run from the repository's root: ``python -m pytest bzbench/tests -q``.
"""
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# a level-1 cell: 100k blocks, so that a small file has the 3 blocks that
# send it through the port's device block encoder (its plain torch path here)
SMALL_CONFIG = {
    "name": "bz1-small", "source": "https://sourceware.org/bzip2/manual/manual.html#options",
    "level": 1, "device": "cuda", "huffman_iters": 8,
    "env": {"TPUBZ_DEVICE_STAGE": "full", "TPUBZ_HYBRID_CPU": "0"},
    "fresh_dir_env": ["TPUBZ_TORCH_CACHE"],
}
SMALL_TRAFFIC = {
    "name": "history-small", "content": "page_history", "file_bytes": 320_000,
    "pool_files": 2, "check_files": 1,
    "page_text_bytes": [4096, 40960], "revisions": [10, 60], "edits": [1, 3], "vocab": 4000,
}


@pytest.fixture
def bench_root(tmp_path):
    """A checkout holding BENCHMARK.json and bzbench/, with the small
    configuration and traffic added as new files."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(REPO, "bzbench"), tmp_path / "bzbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "bzbench" / "configs" / "bz1-small.json").write_text(json.dumps(SMALL_CONFIG))
    (tmp_path / "bzbench" / "traffic" / "history-small.json").write_text(json.dumps(SMALL_TRAFFIC))
    return str(tmp_path)
