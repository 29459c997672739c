"""The port against the JAX package as a whole: every public name of every
JAX module has its counterpart in the port, and every flag of the JAX CLI's
verbs is accepted by the port's CLI alike.

The JAX sources are read as text with ``ast``; nothing of JAX is imported.
A public top-level name (a ``def``, a ``class`` or an UPPER_CASE constant
not starting with ``_``) of a JAX module passes when

(a) the port's counterpart module has it under the same name;
(b) ``RENAMED`` maps it to a port name, which must exist; or
(c) ``NOT_PORTED`` gives its reason, which must be the title of an entry of
    ROADMAP.md's "Deliberately not ported" list (and that list holds no
    other entry).

The Pallas kernel bodies (``_kernel_*``) are private, and (d) each maps to
its CUDA source in ``KERNEL_SOURCES``, which must exist. The counterpart of
``ops/pallas_intersect.py`` is ``ops/packed_intersect.py``; every other
module keeps its path. Port-only modules and names are allowed.
"""

import argparse
import ast
import dataclasses
import importlib
import os
import re

import pytest

from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.render.integrator import IntegratorOptions, resolved_intersector
from gpupathtracer_tpu_torch.render.renderer import RenderSettings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "gpupathtracer_tpu")
PORT_DIR = os.path.join(ROOT, "gpupathtracer_tpu_torch")

MODULE_MAP = {"ops/pallas_intersect.py": "ops/packed_intersect.py"}

RENAMED = {
    "bench.py:ROUND1_RAYS_PER_SEC": "bench.py:BASELINE_RAYS_PER_SEC",
    "ops/pallas_intersect.py:intersect_pallas": "ops/packed_intersect.py:intersect_packed",
    "ops/pallas_intersect.py:intersect_pallas_occluded": "ops/packed_intersect.py:intersect_packed_occluded",
    "ops/plucker.py:PackedTriangles": "ops/packed_intersect.py:PackedScene",
    "ops/plucker.py:pack_triangles": "ops/packed_intersect.py:pack_scene",
    # intersector="plucker": JAX's is a dense search in scene order, the
    # port's runs the plain versions of the packed, culled search
    # (intersect_packed(..., plain=True)); ROADMAP.md, "Known differences".
    "ops/plucker.py:intersect_plucker_jnp": "ops/packed_intersect.py:intersect_packed",
    # That search's acceptance test and least t over a block.
    "ops/plucker.py:decide": "ops/packed_intersect.py:_block_min",
}

MOSAIC = "Mosaic workarounds"
COMPILE_CACHE = "JAX's compile cache"
SCALING_PROBE = "`bench.run_scaling_probe`"
TPU_PROBES = "The v5e MFU/VPU probes"

NOT_PORTED = {
    "ops/pallas_intersect.py:MIN_COMPILED_TRI_BLOCK": MOSAIC,
    "ops/pallas_intersect.py:compiled_tri_block": MOSAIC,
    "utils/debug.py:enable_compile_cache": COMPILE_CACHE,
    "bench.py:run_scaling_probe": SCALING_PROBE,
    "bench.py:V5E_BF16_PEAK_FLOPS": TPU_PROBES,
    "bench.py:EPILOGUE_OPS_PER_PAIR": TPU_PROBES,
}

KERNEL_SOURCES = {
    "ops/pallas_intersect.py:_kernel_resident": "csrc/closest_hit.cu",
    "ops/pallas_intersect.py:_kernel_occlusion": "csrc/occlusion.cu",
    "ops/pallas_intersect.py:_kernel_streamed": "csrc/closest_hit_streamed.cu",
    "ops/pallas_intersect.py:_kernel_occlusion_streamed": "csrc/occlusion_streamed.cu",
}

# The one root-level flag of the JAX CLI and the port's flag in its place.
ROOT_FLAGS = {"--platform": "--device"}

JAX_MODULES = sorted(
    os.path.relpath(os.path.join(d, f), JAX_DIR).replace(os.sep, "/")
    for d, _, files in os.walk(JAX_DIR) for f in files if f.endswith(".py")
)


def _tree(rel: str) -> ast.Module:
    with open(os.path.join(JAX_DIR, rel)) as f:
        return ast.parse(f.read())


def _port_module(rel: str):
    rel = MODULE_MAP.get(rel, rel)
    name = "gpupathtracer_tpu_torch." + rel[: -len(".py")].replace("/", ".")
    return importlib.import_module(name.removesuffix(".__init__"))


def public_names(tree: ast.Module) -> list[str]:
    """Top-level ``def``s, ``class``es and UPPER_CASE constants not
    starting with ``_``, in source order."""
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names += [t.id for t in targets if isinstance(t, ast.Name) and re.fullmatch(r"[A-Z][A-Z0-9_]*", t.id)]
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def kernel_bodies(tree: ast.Module) -> list[str]:
    return [n.name for n in tree.body if isinstance(n, ast.FunctionDef) and n.name.startswith("_kernel_")]


def not_ported_entries() -> list[str]:
    """The bold titles of the bullets of ROADMAP.md's "Deliberately not
    ported" list."""
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        lines = f.read().splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("**Deliberately not ported.**"))
    titles = []
    for line in lines[start + 1:]:
        if line.startswith(("**", "#")):
            break
        m = re.match(r"- \*\*(.+?)\*\*", line)
        if m:
            titles.append(m.group(1).rstrip(".:"))
    return titles


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_its_counterpart(rel):
    tree = _tree(rel)
    port = _port_module(rel)
    missing = []
    for name in public_names(tree):
        key = f"{rel}:{name}"
        if hasattr(port, name):  # (a)
            assert key not in RENAMED and key not in NOT_PORTED, f"{key} is ported under its own name"
        elif key in RENAMED:  # (b)
            target_rel, target = RENAMED[key].split(":")
            assert hasattr(_port_module(target_rel), target), f"{key} -> {RENAMED[key]}, which does not exist"
        elif key not in NOT_PORTED:  # (c)
            missing.append(name)
    assert not missing, f"{rel}: no counterpart in the port, in RENAMED or in NOT_PORTED: {missing}"
    for name in kernel_bodies(tree):  # (d)
        source = KERNEL_SOURCES.get(f"{rel}:{name}")
        assert source and os.path.isfile(os.path.join(PORT_DIR, source)), f"{rel}:{name} has no CUDA source"


def dataclass_fields(rel: str, cls: str) -> set[str]:
    """The annotated fields of class ``cls`` in the JAX module ``rel``."""
    node = next(n for n in _tree(rel).body if isinstance(n, ast.ClassDef) and n.name == cls)
    return {n.target.id for n in node.body if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)}


@pytest.mark.parametrize("rel,port_cls", [("render/renderer.py", RenderSettings),
                                          ("render/integrator.py", IntegratorOptions)],
                         ids=lambda x: getattr(x, "__name__", x))
def test_settings_dataclasses_have_the_jax_fields(rel, port_cls):
    """The render settings and integrator options take the same fields in
    both packages, so a config or caller of one constructs the other."""
    assert {f.name for f in dataclasses.fields(port_cls)} == dataclass_fields(rel, port_cls.__name__)


def test_the_maps_name_jax_names_and_roadmap_lists_the_reasons():
    """Every key of the maps is a name of its JAX module, and ROADMAP.md's
    "Deliberately not ported" list holds exactly the reasons of
    ``NOT_PORTED``."""
    for key in (*RENAMED, *NOT_PORTED, *KERNEL_SOURCES):
        rel, name = key.split(":")
        tree = _tree(rel)
        assert name in public_names(tree) + kernel_bodies(tree), f"{key} is no name of the JAX package"
    assert sorted(set(not_ported_entries())) == sorted(set(NOT_PORTED.values()))


def _jax_parsers() -> dict:
    """The JAX CLI's parsers rebuilt from the ``add_argument`` calls of
    ``main`` in ``gpupathtracer_tpu/cli.py``: ``{verb: parser}``, with the
    root parser under ``""``."""
    main = next(n for n in _tree("cli.py").body if isinstance(n, ast.FunctionDef) and n.name == "main")
    types = {"int": int, "float": float, "str": str}
    value = lambda node: types[node.id] if isinstance(node, ast.Name) else ast.literal_eval(node)
    verbs, parsers = {}, {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            func = node.value.func
            if isinstance(func, ast.Attribute) and func.attr == "add_parser":
                verbs[node.targets[0].id] = ast.literal_eval(node.value.args[0])
            elif isinstance(func, ast.Attribute) and func.attr == "ArgumentParser":
                verbs[node.targets[0].id] = ""
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "add_argument":
            verb = verbs[node.func.value.id]
            parser = parsers.setdefault(verb, argparse.ArgumentParser(add_help=False))
            kw = {k.arg: value(k.value) for k in node.keywords if k.arg != "help"}
            parser.add_argument(*(ast.literal_eval(a) for a in node.args), **kw)
    return parsers


JAX_PARSERS = _jax_parsers()


def _port_parser(verb: str) -> argparse.ArgumentParser:
    root = cli.build_parser()
    if not verb:
        return root
    sub = next(a for a in root._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices[verb]


def _same_argument(a: argparse.Action, want: argparse.Action) -> bool:
    if want.option_strings:
        return bool(set(a.option_strings) & set(want.option_strings))
    return not a.option_strings and a.dest == want.dest


@pytest.mark.parametrize("verb", sorted(JAX_PARSERS), ids=lambda v: v or "root")
def test_every_flag_is_accepted_alike(verb):
    port = [a for a in _port_parser(verb)._actions if not isinstance(a, argparse._HelpAction)]
    for want in JAX_PARSERS[verb]._actions:
        if not verb:  # the root parser: only the documented mapping
            flags = [ROOT_FLAGS[s] for s in want.option_strings]
            assert any(set(flags) & set(a.option_strings) for a in port), f"{want.option_strings} -> {flags}"
            continue
        label = f"{verb} {want.option_strings or want.dest}"
        got = next((a for a in port if _same_argument(a, want)), None)
        assert got, f"{label}: the port's parser has no such argument"
        assert set(got.option_strings) == set(want.option_strings), label
        for attr in ("dest", "choices", "default", "type", "nargs", "const", "required"):
            assert getattr(got, attr) == getattr(want, attr), f"{label}: {attr}"
        assert type(got) is type(want), f"{label}: action"


def test_resolved_intersector_names_the_kernel_route():
    """"auto" resolves to the kernel route, whose wrappers run the plain
    versions on CPU tensors (JAX's resolves to "plucker" off the TPU);
    every other name stands."""
    assert resolved_intersector(IntegratorOptions()) == "pallas"
    for name in ("pallas", "plucker", "brute", "bvh"):
        assert resolved_intersector(IntegratorOptions(intersector=name)) == name
