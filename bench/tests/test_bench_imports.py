"""What the benchmark runs loads neither JAX nor the JAX package (``repro``)
nor the old JAX benchmarks, compared by whole top-level names
(``repro_torch`` is not ``repro``); its plain reference loads nothing of
the program."""
import ast
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _loaded(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter with the benchmark's paths."""
    prog = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(BENCH)!r}]\n{code}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_benchmark_loads_no_jax():
    names = _loaded(
        "import importlib.util, pathlib\n"
        f"spec = importlib.util.spec_from_file_location('bench_run', "
        f"{str(BENCH / 'run.py')!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "import harness.cell, harness.serve, harness.train, harness.trace\n"
        "import reference.transformer\n"
        "from harness import spec as s\n"
        "for p in pathlib.Path(s.BENCH, 'metrics').glob('*.py'):\n"
        "    s.metric_reader(p.stem)\n")
    assert "repro_torch" in names and "torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded("import reference.transformer")
    assert "repro_torch" not in names and not names & FORBIDDEN


def test_no_source_of_the_reference_imports_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in FORBIDDEN | {"repro_torch", "harness"}, \
                    (path.name, m)
