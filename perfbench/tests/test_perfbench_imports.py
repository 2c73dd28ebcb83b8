"""No module that the harness or the reference loads is JAX or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference loads nothing of the program."""

import subprocess
import sys

from perfbench.tests.conftest import ROOT

PROBE = """
import sys
sys.path.insert(0, {root!r})
{imports}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "pbrpathtracer_tpu",
                      "pbrpathtracer_tpu_torch"}}))
"""


def _loaded(imports):
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=ROOT, imports=imports)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_nothing_of_jax_or_the_program():
    assert _loaded("import perfbench.reference.pathtracer") == "[]"


def test_a_harness_run_loads_no_jax():
    imports = """
import torch
torch.set_num_threads(2)
from perfbench.harness import cell
cell.run("cornell.fit", 3, 0.01, 0, "cpu", 0.0,
         overrides={"render": dict(width=16, height=8)},
         log=open("/dev/null", "w"))
print(cell.forbidden_modules(), file=sys.stderr)
"""
    assert _loaded(imports) == "['pbrpathtracer_tpu_torch']"


def test_forbidden_modules_compares_whole_names():
    from perfbench.harness import cell
    sys.modules["pbrpathtracer_tpu_torch_probe"] = sys
    try:
        assert "pbrpathtracer_tpu" not in cell.forbidden_modules()
    finally:
        del sys.modules["pbrpathtracer_tpu_torch_probe"]
