"""Nothing the harness runs imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

from portbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_harness_loads_no_jax_in_a_fresh_process():
    code = ("import os, sys; import portbench.run, portbench.harness, "
            "portbench.trace, portbench.roofline, "
            "portbench.reference, portbench.control\n"
            "from portbench import harness\n"
            "for m in harness.load_json(harness.ROOT, 'BENCHMARK.json')"
            "['per_layer']: harness.reader(m['name'])\n"
            "for d in ('programs', 'generators', 'checks'):\n"
            "    for f in os.listdir(os.path.join(harness.HERE, d)):\n"
            "        f.endswith('.py') and harness.module(d, f[:-3])\n"
            "import hypre_tpu_torch.solvers, hypre_tpu_torch.setup.device_amg\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "hypre_tpu"}
    assert "hypre_tpu_torch" in tops


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hypre_tpu_torch_x", sys)
    assert "hypre_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hypre_tpu.ops", sys)
    assert harness.forbidden_modules() == ["hypre_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    assert _imports(os.path.join(HERE, "reference.py")) <= {
        "__future__", "numpy", "torch", "typing"}


def test_no_source_names_the_jax_era_files():
    banned = ("bench.py", "BENCH_", "BASELINE.json", "MULTICHIP_",
              "chip_smoke")
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py") and "tests" not in dirpath:
                text = open(os.path.join(dirpath, f)).read()
                assert not [b for b in banned if b in text], f
        for f in files:
            if f.endswith(".py"):
                assert not _imports(os.path.join(dirpath, f)) & {
                    "jax", "jaxlib", "flax", "hypre_tpu"}, f
