"""Fixtures of the benchmark's tests: the checkout on the path, and a copy
of the benchmark at tiny sizes that runs on the CPU."""
import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a few threads a process, so that test workers do not oversubscribe the
# cores
torch.set_num_threads(2)

#: each traffic mix cut to a size the CPU runs in a second or two
TINY = {
    "basecall_chunked": dict(reads=5, min_samples=2000, max_samples=5000,
                             batch_size=4, chunk_size=1024, overlap=100,
                             check_reads=5, reference_block=8),
    "basecall_whole": dict(reads=5, min_samples=1000, max_samples=3000,
                           batch_size=2, check_reads=3, reference_rows=2),
    "train": dict(chunks=20, chunk_samples=200, batch_size=4,
                  steps_per_dispatch=3, drop=2),
}


def tiny_tree(dest):
    """A checkout of the benchmark alone (``BENCHMARK.json`` and
    ``benchmark/``) with every traffic mix cut to :data:`TINY`."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, upd in TINY.items():
        path = os.path.join(dest, "benchmark", "traffic", name + ".json")
        with open(path) as f:
            traffic = json.load(f)
        traffic.update(upd)
        with open(path, "w") as f:
            json.dump(traffic, f, indent=1)
    return str(dest)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"))
