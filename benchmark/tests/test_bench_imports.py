"""The import guard: no run loads JAX or the JAX package, compared by the
whole top-level name, and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys
import types

from benchmark import harness, spec

BENCH = os.path.join(spec.ROOT, "benchmark")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _py_files(d):
    for root, _, files in os.walk(d):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    for p in _py_files(BENCH):
        for m in _imports(p):
            assert m.split(".")[0] not in harness.FORBIDDEN, (p, m)


def test_reference_imports_nothing_of_the_program():
    for p in _py_files(os.path.join(BENCH, "reference")):
        for m in _imports(p):
            assert m.split(".")[0] in ("torch", "typing", "math",
                                       "benchmark"), (p, m)
            assert not m.startswith("benchmark.") or \
                m.startswith("benchmark.reference"), (p, m)


def test_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("isopoints_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    before = set(harness.forbidden_modules())
    assert not before & {"isopoints_torch_extra", "jaxtyping", "flaxen"}
    monkeypatch.setitem(sys.modules, "isopoints_tpu.models",
                        types.ModuleType("isopoints_tpu.models"))
    assert "isopoints_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    """What a run imports, in a fresh interpreter."""
    code = ("import benchmark.harness as h, benchmark.trace, "
            "benchmark.control, torch.profiler\n"
            "import isopoints_torch.factories, isopoints_torch.models.generator, "
            "isopoints_torch.core.camera, isopoints_torch.ops.fused_mlp, "
            "isopoints_torch.ops.fused_sampler\n"
            "print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, the
    command exits non-zero and prints no result."""
    import shutil

    shutil.copytree(BENCH, os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "siren-3x256.render512x2", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
