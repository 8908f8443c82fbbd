"""The port's mesh-sharded Sweep (``Sweep.run(mesh=...)`` over a torch
``DeviceMesh``) on the CPU: a sharded sweep is the one-process sweep cut
into per-rank slices, bitwise.

  * two gloo processes, the reference's case (``tests/
    test_sharded_sweep.py``): the paper incast, 3 schemes x roll 0, 300
    steps, a mesh of 2 (3 runs pad to 4), on the flow and the mega tier:
    every trace field and every final leaf equal to the port's
    one-process run, in both ranks; then a mesh of the first rank only,
    which rank 0 runs bitwise and rank 1 (outside it) is refused;
  * four gloo processes on a (2, 2) mesh, a ragged grid of 6 runs
    padded to 8: bitwise;
  * a world of one: bitwise, and within the golden tolerances of the
    reference's ``Sweep.run(mesh=sweep_mesh(1))`` at 200 steps;
  * ``prepare(mesh=)`` stages the rank's slice.

Process groups live in child processes, so no test leaves one behind.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.core as R                                      # noqa: E402
from repro.dist import sweep_mesh as ref_sweep_mesh         # noqa: E402
from _torch_sweeps import assert_golden_close, grid         # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
HOL = {"hol": lambda S: S.paper_incast(roll=0)}


def _env():
    """The children's environment: the port and the tests on the path,
    and no card, so ``sweep_mesh`` builds the cpu mesh these CPU tests
    compare with the one-process CPU run on any machine."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(os.path.dirname(HERE), "src"), HERE,
                    env.get("PYTHONPATH")) if p)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_TWO_RANKS = r"""
import sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
port, rank, tier = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
try:
    import repro_torch.core as P
    from repro_torch.dist import sweep_mesh
    from _torch_sweeps import RAGGED, assert_bitwise, grid
    kw = {"use_kernels": "mega"} if tier == "mega" else {}
    sweep = grid(P, {"hol": RAGGED["hol"]})
    ref = sweep.run(300, device="cpu", **kw)
    mesh = sweep_mesh()
    assert mesh.size() == 2 and mesh.mesh_dim_names == ("run",)
    assert_bitwise(sweep.run(300, mesh=mesh, **kw), ref)
    stg = sweep.prepare(300, mesh=mesh, **kw)
    assert stg.state.nicq.shape[0] == 2          # 3 runs padded to 4, cut
    first = sweep_mesh(1)                        # collective: both ranks
    if rank == 0:
        assert_bitwise(sweep.run(300, mesh=first, **kw), ref)
    else:
        try:
            sweep.run(300, mesh=first, **kw)
            raise SystemExit("a rank outside the mesh ran")
        except ValueError as e:
            assert "outside the mesh" in str(e), e
    print("SHARDED_BITWISE_OK", rank)
finally:
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("tier", ["flow", "mega"])
def test_two_ranks_bitwise(tier):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_RANKS, str(port), str(r), tier],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
            f"{se[-3000:]}"
        assert f"SHARDED_BITWISE_OK {r}" in so


_FOUR_RANKS = r"""
import sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
port, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
try:
    import repro_torch.core as P
    from repro_torch.launch.mesh import make_mesh
    from _torch_sweeps import RUN, assert_bitwise, grid
    sweep = grid(P, RUN)                    # 6 runs: pad to 8, 2 a rank
    mesh = make_mesh((2, 2), ("pod", "data"))
    assert_bitwise(sweep.run(200, mesh=mesh), sweep.run(200, device="cpu"))
    print("SHARDED_2D_OK", rank)
finally:
    dist.destroy_process_group()
"""


def test_four_ranks_on_a_two_dim_mesh_bitwise():
    """The run axis cut row-major over both dims of a (2, 2) mesh: the
    gather runs once a mesh dim, last dim first."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FOUR_RANKS, str(port), str(r)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
            f"{se[-3000:]}"
        assert f"SHARDED_2D_OK {r}" in so


_WORLD_OF_ONE = r"""
import json
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
import repro_torch.core as P
from repro_torch.dist import sweep_mesh
from _torch_sweeps import RAGGED, assert_bitwise, grid
sweep = grid(P, {"hol": RAGGED["hol"]})
mesh = sweep_mesh(1)
assert dist.get_world_size() == 1 and mesh.device_type == "cpu"
try:
    res = sweep.run(200, mesh=mesh)
    assert_bitwise(res, sweep.run(200, device="cpu"))
    try:
        sweep.run(200, mesh=mesh, device="meta")
        raise SystemExit("a device of another type than the mesh's ran")
    except ValueError as e:
        assert "device type" in str(e), e
    print(json.dumps(res.summary(), default=float))
finally:
    dist.destroy_process_group()
"""


def test_world_of_one_bitwise_and_within_golden_of_reference():
    out = subprocess.run([sys.executable, "-c", _WORLD_OF_ONE], env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = grid(R, HOL).run(n_steps=200, mesh=ref_sweep_mesh(1)).summary()
    assert_golden_close(got, want)
