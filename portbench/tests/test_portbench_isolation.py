"""No JAX at run time; no port in the references; no card, no result."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import isolation, manifest

BENCH = manifest.BENCH_DIR


def top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_banned_by_whole_top_level_name():
    mods = {"jax": 1, "jaxlib.xla": 1, "flax.linen": 1, "orbax": 1,
            "unified_audio_tpu.cli": 1, "unified_audio_tpu_torch.cli": 1,
            "jaxtyping": 1, "torch": 1}
    assert isolation.banned_modules(mods) == [
        "flax.linen", "jax", "jaxlib.xla", "orbax", "unified_audio_tpu.cli"]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not set(top_imports(path)) & {"unified_audio_tpu_torch",
                                         *isolation.BANNED}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_benchmark_imports_no_jax(path):
    assert not set(top_imports(path)) & set(isolation.BANNED)


def test_drivers_leave_no_jax_loaded():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.harness import manifest, isolation\n"
            "b = manifest.load_manifest()\n"
            "for w in b['workloads']:\n"
            "    p = manifest.cell_params(w['name'])\n"
            "    d = manifest.load_module(manifest.driver_path(p['driver']),"
            " 'drivers.' + p['driver'])\n"
            "    d._port()\n"
            "    manifest.load_module(manifest.reference_path(w['config']),"
            " 'reference.' + w['config'])\n"
            "print(isolation.banned_modules())\n") % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_fails_with_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "unise-serve-c96-s64", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(Path.home())})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr
