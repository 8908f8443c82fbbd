"""The port stands alone: ``repro_torch`` imports neither JAX nor the
reference package, and ``chip_smoke.py`` refuses to run without a GPU
or without the repository around it."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    # the reference's dry run writes XLA_FLAGS at import, into a worker
    # that imported it; a child must start without it to show that the
    # port's modules write none
    env.pop("XLA_FLAGS", None)
    return env


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.net, "
            "repro_torch.convert, repro_torch.kernels.cc_step, "
            "repro_torch.kernels.fluid_reduce, repro_torch.kernels.fluid_step, "
            "repro_torch.kernels.build, repro_torch.core.experiments, "
            "repro_torch.models, repro_torch.configs, repro_torch.serve, "
            "repro_torch.launch.serve, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.decode_attention, repro_torch.kernels.ops, "
            "repro_torch.tune, repro_torch.tune.soft, "
            "repro_torch.tune.objectives, repro_torch.tune.optimizers, "
            "repro_torch.tune.pareto, repro_torch.ckpt, "
            "repro_torch.ckpt.checkpoint, repro_torch.core.serialize, "
            "repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.models.rglru, repro_torch.models.scan, "
            "repro_torch.models.encdec, repro_torch.models.vlm, "
            "repro_torch.configs.common, repro_torch.optim, "
            "repro_torch.optim.adamw, repro_torch.optim.compress, "
            "repro_torch.optim.schedule, repro_torch.data, "
            "repro_torch.data.pipeline, repro_torch.train, "
            "repro_torch.train.step, repro_torch.train.loop, "
            "repro_torch.launch.train, repro_torch.dist, "
            "repro_torch.dist.sharding, repro_torch.dist.pipeline, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.launch.perf; "
            "from repro_torch.serve import make_serve_step, whatif; "
            "import os, torch.distributed as dist; "
            "assert not dist.is_initialized(); "
            "assert 'XLA_FLAGS' not in os.environ; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("pkg", ["serve", "models", "optim", "train",
                                 "data", "dist"])
def test_package_names_match_reference(pkg):
    """``repro_torch.<pkg>`` binds the reference's names (the mesh
    helpers of ``models``, ``optim`` and ``train`` too); ``dist`` binds
    the reference's five beside its ``procs`` and ``pacer`` names."""
    import importlib
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    if pkg == "dist":
        assert set(ref.__all__) <= set(port.__all__)
    else:
        assert set(port.__all__) == set(ref.__all__)
    if pkg == "serve":
        assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert hasattr(port, name), name


@pytest.mark.parametrize("mod", ["dryrun", "perf"])
def test_launch_module_names_match_reference(mod):
    """``repro_torch.launch.<mod>`` defines the reference module's
    functions (read from its source: importing it writes XLA_FLAGS)."""
    import importlib
    path = os.path.join(ROOT, "src", "repro", "launch", f"{mod}.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    port = importlib.import_module(f"repro_torch.launch.{mod}")
    # the reference's lower-and-compile is the port's ``_trace_cell``;
    # its batch builder ``_abstract_inputs`` is part of ``abstract_cell``
    names -= {"_compile_cell", "_abstract_inputs"}
    assert callable(port.__dict__.get(
        "_trace_cell" if mod == "dryrun" else "measure"))
    assert names and all(callable(getattr(port, n, None)) for n in names), (
        sorted(n for n in names if not hasattr(port, n)))


def test_serving_needs_a_gpu_or_the_cpu_by_request(monkeypatch):
    """``init_params`` and ``ServingEngine`` run on the card by default
    and raise without one; ``device="cpu"`` runs them on the CPU."""
    import torch
    from repro_torch.models import ModelConfig, transformer
    from repro_torch.models.layers import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(name="tiny", n_layers=1, d_model=16, n_heads=2,
                      n_kv_heads=1, head_dim=8, d_ff=32, vocab=32)
    defs = transformer.param_defs(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(defs, 0)
    params = init_params(defs, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params, ServeConfig())
    eng = ServingEngine(cfg, params, ServeConfig(batch_slots=1, max_len=8),
                        device="cpu")
    assert len(eng.generate([[2, 3]], max_new_tokens=2)[0]) >= 1


def test_no_port_file_imports_jax_or_reference():
    for dirpath, _, files in os.walk(PORT):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                for n in names:
                    top = n.split(".")[0]
                    assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """No card here: chip_smoke exits non-zero and prints no result —
    from the repository, and alone in an empty directory."""
    code = ("import runpy, sys, torch; "
            "torch.cuda.is_available = lambda: False; "
            "sys.argv = [sys.argv[1]]; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    for script in (os.path.join(ROOT, "chip_smoke.py"),
                   shutil.copy(os.path.join(ROOT, "chip_smoke.py"),
                               tmp_path / "chip_smoke.py")):
        out = subprocess.run([sys.executable, "-c", code, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=os.path.dirname(str(script)))
        assert out.returncode != 0, out.stdout
        assert '"ok"' not in out.stdout


def test_chip_smoke_alone_refuses_even_with_a_gpu(tmp_path):
    """Copied out of the repository, the script finds no port to drive."""
    script = shutil.copy(os.path.join(ROOT, "chip_smoke.py"),
                         tmp_path / "chip_smoke.py")
    code = ("import runpy, sys, torch; "
            "torch.cuda.is_available = lambda: True; "
            "runpy.run_path(sys.argv[1], run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code, str(script)],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode != 0, out.stdout
    assert "not found" in out.stderr
    assert '"ok"' not in out.stdout
