"""The port's logical sharding rules and meshes (``repro_torch.dist.
sharding``, ``repro_torch.launch.mesh``) against the reference's, on the
CPU.

  * ``pspec`` on the reference's own cases (``tests/test_substrates.py``:
    joint axes on a (2, 2, 1) mesh, a batch they do not divide, vocab
    92,553) equals the reference's on an ``AbstractMesh``;
  * for every config in ``ARCHS`` and every leaf of its param defs, on
    both production sizes, the port's ``pspec`` and ``shard_shape``
    equal the reference's ``pspec`` and ``NamedSharding.shard_shape``;
  * in a child process on torch's ``fake`` backend (worlds of 256 and
    512 ranks), ``make_production_mesh`` / ``describe`` and
    ``distribute_tensor`` under ``FakeTensorMode`` give those local
    shapes;
  * in four gloo processes, a joint ("pod", "data") dim hands rank (p,
    d) chunk p * 2 + d, JAX's major-to-minor order;
  * ``shard`` is the identity outside a mesh and lays a tensor out on
    its placements inside ``set_mesh``; ``sweep_mesh`` refuses sizes
    outside 1..world before it initialises anything.
"""

import json
import os
import socket
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import repro.dist                                           # noqa: E402,F401
from jax.sharding import AbstractMesh                       # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding    # noqa: E402
from repro.configs import ARCHS, get_config                 # noqa: E402
from repro.dist.sharding import DEFAULT_RULES as REF_RULES  # noqa: E402
from repro.dist.sharding import pspec as ref_pspec          # noqa: E402
from repro.models import encdec, layers, transformer, vlm   # noqa: E402

import torch.distributed as dist                            # noqa: E402
from repro_torch.dist import sharding as S                  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"single_pod": ((16, 16), ("data", "model")),
         "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape, names):
    """What the port's rules read of a mesh: its dim names and sizes."""
    return types.SimpleNamespace(mesh_dim_names=tuple(names),
                                 shape=tuple(shape))


def _ref_defs(cfg):
    if cfg.encdec is not None:
        return encdec.param_defs(cfg)
    if cfg.vlm is not None:
        return vlm.param_defs(cfg)
    return transformer.param_defs(cfg)


def _leaves(arch):
    """(dims, shape) of every ParamDef leaf of the reference's defs."""
    defs = jax.tree.leaves(_ref_defs(get_config(arch)),
                           is_leaf=layers.is_def)
    return [(tuple(d.dims), tuple(d.shape)) for d in defs]


def _child_env():
    """The port on the path and no card: the meshes these CPU tests build
    are cpu meshes on any machine."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_default_rules_are_the_reference_rules():
    assert S.DEFAULT_RULES == REF_RULES


@pytest.mark.parametrize("sizes, names, dims, shape", [
    ((2, 2, 1), ("pod", "data", "model"), ("batch", None), (8, 4)),
    ((2, 2, 1), ("pod", "data", "model"), ("batch", None), (3, 4)),
    ((1, 1), ("data", "model"), ("vocab",), (92553,)),
    ((16, 16), ("data", "model"), ("vocab", "fsdp"), (92553, 6144)),
    ((2, 16, 16), ("pod", "data", "model"),
     ("cache_batch", "kv_seq", "kv_heads", None), (64, 4096, 8, 128)),
])
def test_pspec_reference_cases(sizes, names, dims, shape):
    want = ref_pspec(dims, shape, REF_RULES, AbstractMesh(sizes, names))
    got = S.pspec(dims, shape, S.DEFAULT_RULES, _mesh(sizes, names))
    assert isinstance(got, S.PartitionSpec)
    assert tuple(got) == tuple(want)


def test_pspec_joint_axes_and_guard():
    mesh = _mesh((2, 2, 1), ("pod", "data", "model"))
    assert S.pspec(("batch", None), (8, 4), S.DEFAULT_RULES,
                   mesh)[0] == ("pod", "data")
    assert S.pspec(("batch", None), (3, 4), S.DEFAULT_RULES,
                   mesh)[0] is None
    sh = S.logical_sharding(("batch", None), (8, 4), mesh)
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements == (Shard(0), Shard(0), Replicate())
    assert sh.shard_shape((8, 4)) == (2, 4)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_param_leaf_matches_reference(arch, size):
    sizes, names = SIZES[size]
    amesh = AbstractMesh(sizes, names)
    mesh = _mesh(sizes, names)
    for dims, shape in _leaves(arch):
        want = ref_pspec(dims, shape, REF_RULES, amesh)
        got = S.logical_sharding(dims, shape, mesh)
        assert tuple(got.spec) == tuple(want), (arch, dims, shape)
        assert got.shard_shape(shape) == tuple(
            JNamedSharding(amesh, want).shard_shape(shape)), (arch, dims)


_FAKE_CHILD = r"""
import json, sys
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.dist.sharding import logical_sharding
from repro_torch.launch.mesh import describe, make_production_mesh

cases = json.loads(sys.stdin.read())
out = {}
for multi_pod, world in ((False, 256), (True, 512)):
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        got = {"describe": describe(mesh), "size": mesh.size(), "local": []}
        with FakeTensorMode():
            for dims, shape in cases:
                sh = logical_sharding(dims, shape, mesh)
                x = torch.empty(shape, dtype=torch.bfloat16)
                d = distribute_tensor(x, mesh, sh.placements)
                got["local"].append([list(d.to_local().shape),
                                     list(sh.shard_shape(shape))])
        out[str(world)] = got
    finally:
        dist.destroy_process_group()
try:
    dist.init_process_group("fake", rank=0, world_size=3, store=FakeStore())
    make_production_mesh()
    out["wrong_world"] = None
except ValueError as e:
    out["wrong_world"] = str(e)
print(json.dumps(out))
"""


def test_production_meshes_on_the_fake_backend():
    cases = sorted({(dims, shape) for a in ARCHS for dims, shape in
                    _leaves(a)}, key=repr)
    out = subprocess.run([sys.executable, "-c", _FAKE_CHILD],
                         input=json.dumps(cases), env=_child_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["256"]["describe"] == "data=16 x model=16"
    assert got["512"]["describe"] == "pod=2 x data=16 x model=16"
    assert (got["256"]["size"], got["512"]["size"]) == (256, 512)
    assert "256" in got["wrong_world"] and "3" in got["wrong_world"]
    for world, (sizes, names) in (("256", SIZES["single_pod"]),
                                  ("512", SIZES["multi_pod"])):
        amesh = AbstractMesh(sizes, names)
        for (dims, shape), (local, port) in zip(cases, got[world]["local"]):
            want = JNamedSharding(
                amesh, ref_pspec(dims, shape, REF_RULES, amesh)
            ).shard_shape(shape)
            assert tuple(local) == tuple(port) == tuple(want), \
                (world, dims, shape)
    # gemma2-27b's stacked kv projection, the example of the rules
    amesh = AbstractMesh(*SIZES["single_pod"])
    dims, shape = ("layers", "fsdp", "kv_heads", None), (23, 4608, 16, 128)
    assert S.logical_sharding(dims, shape, _mesh(*SIZES["single_pod"])) \
        .shard_shape(shape) == (23, 288, 1, 128) == tuple(
            JNamedSharding(amesh, ref_pspec(dims, shape, REF_RULES, amesh))
            .shard_shape(shape))


_JOINT_CHILD = r"""
import sys
import torch, torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from repro_torch.dist.sharding import logical_sharding
from repro_torch.launch.mesh import make_mesh

port, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
try:
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
    p, d, _ = mesh.get_coordinate()
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    sh = logical_sharding(("batch", None), (8, 3), mesh)
    local = distribute_tensor(x, mesh, sh.placements).to_local()
    chunk = p * 2 + d
    assert torch.equal(local, x[2 * chunk:2 * chunk + 2]), (rank, local)
    print("JOINT_OK", rank)
finally:
    dist.destroy_process_group()
"""


def test_joint_axes_split_major_to_minor_in_four_ranks():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JOINT_CHILD, str(port), str(r)],
        env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, se[-3000:]
        assert f"JOINT_OK {r}" in so


def test_shard_is_identity_outside_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert S.ambient_mesh() is None
    assert S.shard(x, "batch", "mlp") is x


_SHARD_CHILD = r"""
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.dist.sharding import ambient_mesh, set_mesh, shard
from repro_torch.launch.mesh import make_host_mesh

mesh = make_host_mesh()
try:
    x = torch.arange(6.0).reshape(2, 3)
    with set_mesh(mesh):
        assert ambient_mesh() is mesh
        y = shard(x, "batch", "mlp")
        z = shard(y, None, None)
    assert ambient_mesh() is None
    assert isinstance(y, DTensor) and isinstance(z, DTensor)
    assert y.placements == (Replicate(), Replicate())
    assert torch.equal(z.full_tensor(), x)
    print("SHARD_OK")
finally:
    dist.destroy_process_group()
"""


def test_shard_lays_out_under_set_mesh():
    out = subprocess.run([sys.executable, "-c", _SHARD_CHILD],
                         env=_child_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SHARD_OK" in out.stdout


@pytest.mark.parametrize("n", [0, 10_000])
def test_sweep_mesh_validation(n):
    was = dist.is_initialized()
    with pytest.raises(ValueError, match="outside"):
        S.sweep_mesh(n)
    assert dist.is_initialized() == was


def test_named_sharding_refuses_axes_out_of_mesh_order():
    sh = S.NamedSharding(_mesh((2, 2), ("pod", "data")),
                         S.PartitionSpec(("data", "pod")))
    with pytest.raises(ValueError, match="order"):
        sh.placements
