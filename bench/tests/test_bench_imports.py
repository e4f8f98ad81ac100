"""No module the benchmark runs is JAX's or the JAX package's, and the
reference imports nothing of the program.  Top-level names are compared
whole: ``repro_torch`` is the port, ``repro`` the JAX package."""
import ast
import json
import subprocess
import sys

from bench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_modules(code: str) -> set:
    p = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=300,
        env={"PYTHONPATH": f"{spec.ROOT}:{spec.ROOT / 'src'}",
             "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole tiny run of each cell, measured and traced, in a fresh
    process."""
    code = (
        "import time, torch\n"
        "torch.set_num_threads(1)\n"
        "from bench.harness import main, calibrate\n"
        "from bench.tests._tiny import CELLS, tiny\n"
        "for name in CELLS:\n"
        "    for trace in (False, True):\n"
        "        main.run_cell(tiny(name), 3, 0.05, trace, 'cpu',\n"
        "                      time.perf_counter())\n"
        "from bench.harness import spec\n"
        "c = spec.load_cell('mlp3-xdevice')\n"
        "spec.metric_readers(c.per_layer)\n")
    mods = _top_modules(code)
    assert not mods & FORBIDDEN, mods & FORBIDDEN
    assert "repro_torch" in mods


def test_reference_imports_nothing_of_the_program():
    paths = sorted((spec.ROOT / "bench/reference").glob("*.py"))
    mods = _top_modules("import " + ", ".join(
        f"bench.reference.{p.stem}" for p in paths if p.stem != "__init__"))
    assert not mods & (FORBIDDEN | {"repro_torch"})
    for path in paths:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"repro_torch"}, \
                    (path.name, n)
