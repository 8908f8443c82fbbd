"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level names compared whole: ``repro_torch`` begins with ``repro``),
and the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _child(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]), CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_reference_loads_neither_jax_nor_the_program():
    got = _child(
        "import json, sys\n"
        "from ccbench.harness import cell, check\n"
        "c = cell.load('clos64_paper.incast_mega', 3,"
        " {'config': {'horizon_steps': 1100}})\n"
        "check.reference_result(c, [0, 5], c.scale(0))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(got) & set(FORBIDDEN + ("repro_torch",)), got


def test_a_run_loads_no_jax_nor_the_jax_package():
    got = _child(
        "import importlib.util, json, sys\n"
        "spec = importlib.util.spec_from_file_location('r', "
        "'ccbench/run.py')\n"
        "r = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(r)\n"
        "r.run_cell('clos64_paper.incast_mega', 3, 0.1, False, "
        "device='cpu', overrides={'config': {'horizon_steps': 1100}})\n"
        "print(json.dumps([sorted({m.split('.')[0] for m in sys.modules}),"
        " r.forbidden_modules()]))")
    tops, bad = got
    assert bad == [] and not set(tops) & set(FORBIDDEN)
    assert "repro_torch" in tops
