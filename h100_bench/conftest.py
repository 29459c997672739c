"""Test settings of the benchmark's own tests: the ``cuda`` mark, a fixture
that skips without a card, and a tiny copy of the benchmark for the CPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"config3_icosphere": (24, 2), "config6_icosphere": (24, 2)}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def make_tiny(dest: str, size: dict = TINY) -> str:
    """A copy of ``BENCHMARK.json`` and the benchmark's folder in ``dest``,
    with each configuration cut to ``size[name] = (pixels a side, sphere
    subdivisions)``."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(REPO, "h100_bench"), os.path.join(dest, "h100_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, (px, sub) in size.items():
        path = os.path.join(dest, "h100_bench", "configs", name + ".json")
        with open(path) as f:
            cfg = json.load(f)
        cfg["render"]["width"] = cfg["render"]["height"] = px
        cfg["geometry"][0]["subdivisions"] = sub
        with open(path, "w") as f:
            json.dump(cfg, f)
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))


# Runs a cell of a tiny copy on the CPU in a fresh process (the program
# from this checkout), with the streamed route forced where asked, a fault
# of the cell's loop kind planted where named (or the control,
# "precision:<mode>"), and prints the loaded top-level modules last.
_DRIVER = """
import json, sys
root, streamed, fault, argv = sys.argv[1], sys.argv[2] == "1", sys.argv[3], sys.argv[4:]
sys.path[:0] = [root, {repo!r}]
if streamed:
    from gpupathtracer_tpu_torch.ops import packed_intersect
    packed_intersect.RESIDENT_BUDGET_BYTES = 64 * 1024
    packed_intersect.CLUSTER_TARGET_BYTES = 16 * 1024
from h100_bench import faults, run, spec
import contextlib
if fault == "-":
    plant = contextlib.nullcontext()
elif fault.startswith("precision:"):
    plant = faults.precision(fault.split(":", 1)[1])
else:
    plant = spec.loop(root, spec.load_cell(root, argv[argv.index("--workload") + 1])).FAULTS[fault]()
with plant:
    code = run.main(argv, device="cpu", root=root)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
sys.exit(code)
"""


def run_cpu(root: str, argv: list, streamed: bool = False, fault: str = "-", timeout: int = 600):
    """``(exit code, result line, loaded top-level modules, stderr)``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.setdefault("OMP_NUM_THREADS", "4")
    p = subprocess.run([sys.executable, "-c", _DRIVER.format(repo=REPO), root, "1" if streamed else "0", fault,
                        *argv], capture_output=True, text=True, timeout=timeout, env=env, cwd=root)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-2]) if p.returncode == 0 and len(lines) >= 2 else None
    modules = json.loads(lines[-1]) if lines else []
    return p.returncode, result, modules, p.stderr
