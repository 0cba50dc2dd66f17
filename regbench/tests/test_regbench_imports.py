"""What the harness and the reference load: no module whose top-level
name is jax, jaxlib, flax or the JAX package (the port's name begins
with the JAX package's, so names are compared whole), and nothing of the
program in the reference."""

import ast
import json
import subprocess
import sys

import _paths

FORBIDDEN = {"jax", "jaxlib", "flax", "fccf_pcr_tpu"}


def loaded_after(code):
    """Top-level names in sys.modules after ``code`` runs in a fresh
    interpreter with the benchmark's folder and the root on the path."""
    prog = (f"import sys; sys.path[:0] = [{str(_paths.BENCH)!r}, "
            f"{str(_paths.ROOT)!r}]\n{code}\nimport json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=_paths.ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = loaded_after(
        "import run, readings, refpipe\n"
        "from benchlib import compare, loop, pool, propagate_work, readers, "
        "scene, spec, trace, traced\n"
        "import fccf_pcr_torch, fccf_pcr_torch.pipeline.register\n"
        "from benchlib import spec as s\n"
        "bench = s.manifest()\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    s.reader(m['name'])\n"
        "for mod in run.KERNEL_MODULES:\n"
        "    __import__('fccf_pcr_torch.' + mod)\n")
    assert not names & FORBIDDEN
    assert "fccf_pcr_torch" in names


def test_reference_loads_nothing_of_the_program():
    names = loaded_after("import refpipe")
    assert "fccf_pcr_torch" not in names
    assert not names & FORBIDDEN


def test_reference_sources_import_nothing_of_the_program():
    for path in (_paths.BENCH / "refpipe").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in FORBIDDEN | {"fccf_pcr_torch"}, (path, m)


def test_harness_sources_name_no_other_file_of_the_repo():
    """The benchmark imports nothing from bench.py, chip_smoke.py or
    tools/."""
    for path in _paths.BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import)
                        else [node.module or ""])
                for m in mods:
                    assert m.split(".")[0] not in {"bench", "chip_smoke",
                                                   "tools"}, (path, m)
