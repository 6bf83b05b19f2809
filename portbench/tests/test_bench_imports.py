"""No module a run loads is JAX's or the JAX package's, compared by whole
top-level names (``loner_tpu_torch`` begins with ``loner_tpu``), and the
reference imports nothing of the port."""
import ast
import json
import subprocess
import sys

from portbench import harness

PKG = harness.PKG


def _loaded(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=str(harness.ROOT), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_module_a_run_loads_is_jax_or_the_jax_package():
    code = """
import json, sys
from portbench import harness, control, costs, peaks, portcfg, trace, run
from portbench.drivers import train_window, train_mesh
from portbench.reference import plain, compare
spec = harness.load_spec()
for m in spec["per_layer"]:
    harness.load_metric(m["name"])
import loner_tpu_torch.mapping.optimizer, loner_tpu_torch.mapping.phase_graph
import loner_tpu_torch.parallel.mesh
print(json.dumps({"forbidden": harness.forbidden_modules(),
                  "port": "loner_tpu_torch" in sys.modules}))
"""
    got = _loaded(code)
    assert got == {"forbidden": [], "port": True}


def test_forbidden_names_are_whole_top_level_names():
    sys.modules.setdefault("loner_tpu_torch_probe_x", object())
    try:
        assert "loner_tpu_torch_probe_x" not in harness.forbidden_modules()
    finally:
        del sys.modules["loner_tpu_torch_probe_x"]
    assert "loner_tpu" in harness.FORBIDDEN and "jax" in harness.FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((PKG / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("loner_tpu_torch", "loner_tpu", "jax", "jaxlib", "flax"), (
                    f"{path.name} imports {name}")
    got = _loaded("import json, sys\nfrom portbench.reference import plain, compare\n"
                  "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
                  "{'loner_tpu_torch', 'loner_tpu', 'jax'})))")
    assert got == []
