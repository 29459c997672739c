"""The benchmark's c6-nee cell end to end on the CPU, on a tiny copy of the
benchmark (``h100_bench.conftest.make_tiny``: 24x24 frames, a
subdivision-2 sphere) with the streamed route forced, as the card runs it:
the program's NEE frames against ``reference/nee.py``, untraced and traced,
the check's control, and the faults the cell's loop lists.

Imports no JAX; each run is a fresh process (``run_cpu``)."""

import json
import os

import pytest

from h100_bench.conftest import REPO, TINY, make_tiny, run_cpu

CELL = "c6-nee"
FORBIDDEN = {"jax", "jaxlib", "flax", "gpupathtracer_tpu"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("c6nee")), {**TINY, "config6_nee": (24, 2)})


def _argv(seed, trace=0):
    return ["--workload", CELL, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_and_its_check_passes(tiny, trace):
    code, result, modules, err = run_cpu(tiny, _argv(2 ** 31 + 12345, trace), streamed=True)
    assert code == 0, err[-3000:]
    assert result["correct"], result["check"]
    assert list(result["check"]) == ["diverged_px_share"]
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    if trace:
        # No device on the CPU: the device metrics find nothing to read.
        assert result["metrics"] == {}
    else:
        want = {m["name"] for m in spec["end_to_end"] if CELL in m.get("workloads", [CELL])}
        assert set(result["metrics"]) == want == {"rays_per_s", "frame_ms_p95", "setup_s"}
    assert not FORBIDDEN & set(modules)


@pytest.mark.parametrize("fault", ["precision:default", "altered_shadow"])
def test_the_control_and_a_wrong_any_hit_fail(tiny, fault):
    code, result, _, err = run_cpu(tiny, _argv(99), streamed=True, fault=fault)
    assert code == 0, err[-3000:]
    assert not result["correct"], result["check"]
