"""The benchmark driven end to end on the CPU at a tiny size, program against
reference: every cell untraced and traced, the control and each fault a
cell can have, cells added by name, and what the runs import."""

import ast
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from h100_bench.conftest import REPO, make_tiny, run_cpu

CELLS = {"c3-render": False, "c6-render": True, "c3-grad": False}  # cell: streamed route forced
FORBIDDEN = {"jax", "jaxlib", "flax", "gpupathtracer_tpu"}


def _argv(cell, seed, trace=0, seconds=1.0):
    return ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]


def _benchmark():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_dry_run(tiny, cell, trace):
    code, result, modules, err = run_cpu(tiny, _argv(cell, 2 ** 31 + 12345, trace), streamed=CELLS[cell])
    assert code == 0, err[-3000:]
    assert result["correct"], result["check"]
    assert list(result)[-1] == "check"
    assert result["attempted"] >= (3 + 2 if trace else 1)
    spec = _benchmark()
    want = {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
    if trace:
        # No device on the CPU: the device metrics find nothing to read.
        assert result["metrics"] == {}
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
    else:
        assert set(result["metrics"]) == want
    assert not FORBIDDEN & set(modules)


def test_the_control_fails(tiny_control):
    """The check's control: the program's searches at "default" (one
    bfloat16 product) in place of the configuration's "highest"."""
    code, result, _, err = run_cpu(tiny_control, _argv("c3-render", 4242), fault="precision:default")
    assert code == 0, err[-3000:]
    assert not result["correct"], result["check"]


@pytest.fixture(scope="module")
def tiny_control(tmp_path_factory):
    # Large enough that the bfloat16 decisions change some paths.
    return make_tiny(str(tmp_path_factory.mktemp("control")), {"config3_icosphere": (64, 3)})


@pytest.mark.parametrize("cell,fault", [
    ("c3-render", "half_batch"), ("c3-render", "altered_answer"), ("c6-render", "altered_answer"),
    ("c3-grad", "unchanged_state"), ("c3-grad", "half_batch"), ("c3-grad", "altered_answer"),
    ("c3-grad", "stray_gradient"),
])
def test_a_fault_fails(tiny, cell, fault):
    code, result, _, err = run_cpu(tiny, _argv(cell, 99), streamed=CELLS[cell], fault=fault)
    assert code == 0, err[-3000:]
    assert not result["correct"], result["check"]


def _digest(root, files=None):
    """A hash of the benchmark's code (of ``files``, paths under ``root``)."""
    h = hashlib.sha256()
    paths = sorted(glob.glob(os.path.join(root, "h100_bench", "**", "*.py"), recursive=True)) if files is None else \
        [os.path.join(root, f) for f in files]
    for p in paths:
        with open(p, "rb") as f:
            h.update(p.encode() + f.read())
    return h.hexdigest()


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "h100_bench", "**", "*"),
                                                               recursive=True) if os.path.isfile(p))


def _add(root, spec_lists: dict):
    """Append entries to ``root``'s BENCHMARK.json."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    for key, entries in spec_lists.items():
        spec[key].extend(entries)
    with open(path, "w") as f:
        json.dump(spec, f)


def test_a_cell_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = make_tiny(str(tmp_path))
    before = _digest(root)
    bench = os.path.join(root, "h100_bench")
    shutil.copy(os.path.join(bench, "configs", "config3_icosphere.json"), os.path.join(bench, "configs", "extra.json"))
    with open(os.path.join(bench, "traffic", "frames_spp1.json"), "w") as f:
        json.dump({"loop": "frames", "spp": 1, "warmup": 1, "check_frames": 1, "check_pixels": 0, "work_rays": 64,
                   "traced_items": 1}, f)
    with open(os.path.join(bench, "limits", "extra-spp1.json"), "w") as f:
        json.dump({"diverged_px_share": 0.0002}, f)
    with open(os.path.join(bench, "metrics", "frames_in_window.py"), "w") as f:
        f.write('"""frames_in_window (frames): items of the window."""\n\n\ndef read(run):\n    return len(run.ends)\n')
    _add(root, {
        "configs": [{"name": "extra", "source": "x", "file": "h100_bench/configs/extra.json", "reduced": [],
                     "why": "x"}],
        "workloads": [{"name": "extra-spp1", "config": "extra", "traffic": "frames_spp1", "chips": 1, "why": "x"}],
        "end_to_end": [{"name": "frames_in_window", "unit": "frames", "better": "higher", "bound": 0.1,
                        "source": "host_clock", "workloads": ["extra-spp1"]}]})
    code, result, _, err = run_cpu(root, _argv("extra-spp1", 5))
    assert code == 0, err[-3000:]
    assert result["correct"] and result["metrics"]["frames_in_window"]["value"] == result["attempted"]
    assert set(result["metrics"]) == {"frames_in_window", "setup_s"}
    assert _digest(root) != before  # the new reader is there ...
    os.remove(os.path.join(bench, "metrics", "frames_in_window.py"))
    assert _digest(root) == before  # ... and no other code changed


_NEW_LOOP = '''"""Each item renders two frames back to back."""

from h100_bench.loops import frames


class Loop(frames.Loop):
    def item(self, i):
        super().item(2 * i)
        super().item(2 * i + 1)

    def describe(self, setup_s, starts, ends):
        run = super().describe(setup_s, starts, ends)
        run.rays_per_item *= 2
        return run


judge = frames.judge
FAULTS = {"half_batch": frames.FAULTS["half_batch"]}
'''


def test_a_new_loop_kind_is_found_by_name(tmp_path):
    """A loop kind, its traffic, cell and a metric read by an existing
    reader (``rays_per_s.twice`` by ``metrics/rays_per_s.py``) are new files
    and entries; no file that was there changes."""
    root = make_tiny(str(tmp_path))
    existing = _files(root)
    before = _digest(root, existing)
    bench = os.path.join(root, "h100_bench")
    with open(os.path.join(bench, "loops", "frames_twice.py"), "w") as f:
        f.write(_NEW_LOOP)
    with open(os.path.join(bench, "traffic", "twice_spp2.json"), "w") as f:
        json.dump({"loop": "frames_twice", "spp": 2, "warmup": 1, "check_frames": 2, "check_pixels": 0,
                   "work_rays": 64, "traced_items": 1}, f)
    with open(os.path.join(bench, "limits", "c3-twice.json"), "w") as f:
        json.dump({"diverged_px_share": 0.0004}, f)
    _add(root, {
        "workloads": [{"name": "c3-twice", "config": "config3_icosphere", "traffic": "twice_spp2", "chips": 1,
                       "why": "x"}],
        "end_to_end": [{"name": "rays_per_s.twice", "unit": "rays/s", "better": "higher", "bound": 0.1,
                        "source": "host_clock", "workloads": ["c3-twice"]}]})
    code, result, _, err = run_cpu(root, _argv("c3-twice", 6))
    assert code == 0, err[-3000:]
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"rays_per_s.twice", "setup_s"}
    code, result, _, err = run_cpu(root, _argv("c3-twice", 6), fault="half_batch")
    assert code == 0, err[-3000:]
    assert not result["correct"], result["check"]
    assert _digest(root, existing) == before


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(REPO, "h100_bench", "reference", "**", "*.py"), recursive=True)
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN | {"gpupathtracer_tpu_torch"}, (path, name)
    code = ("import json, sys; sys.path.insert(0, {!r}); import torch; "
            "from h100_bench.reference import scene, trace; "
            "cfg = scene.load_config({!r}); s = scene.build_scene(cfg, 'cpu'); b = trace.build_boxes(s); "
            "cam = scene.build_camera(cfg); "
            "trace.trace_pixels(s, b, cam, torch.arange(100), 1, 2, 4); "
            "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))").format(
        REPO, os.path.join(REPO, "h100_bench", "configs", "config3_icosphere.json"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"gpupathtracer_tpu_torch"})


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    p = subprocess.run([sys.executable, "h100_bench/run.py", *_argv("c3-render", 31337, 0, 2.0)], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
