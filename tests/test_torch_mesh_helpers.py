"""The port's mesh helpers against the reference's, on the CPU: the
logical-dims trees of params (``layers.param_specs``), of caches
(``transformer.cache_specs``, ``encdec.dec_cache_specs``) and of the
optimizer and train states (``opt_state_specs``, ``train_state_specs``),
and ``layers.abstract_params`` (meta-device tensors for the reference's
ShapeDtypeStructs).  The reference stacks each scanned group's layers
behind a leading ``layers`` axis; the port keeps one entry a layer, so
the reference's trees are unstacked (``_port_layout``, the layout
``convert.params_from_numpy`` gives) before they are compared, field for
field.  Then the elastic restore: ``load_checkpoint(shardings=)`` after
``tests/test_substrates.py``'s case, and ``train_loop(state_shardings=)``
resuming bitwise, each in a world-of-one child process."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
from repro.configs import ARCHS                             # noqa: E402
from repro.configs import get_config as ref_config          # noqa: E402
from repro.models import encdec as r_encdec                 # noqa: E402
from repro.models import layers as r_layers                 # noqa: E402
from repro.models import transformer as r_transformer       # noqa: E402
from repro.models import vlm as r_vlm                       # noqa: E402
from repro.optim import AdamWConfig as RAdamW               # noqa: E402
from repro.optim import opt_state_specs as r_opt_specs      # noqa: E402
from repro.train import train_state_specs as r_train_specs  # noqa: E402
from repro.train.step import StepConfig as RStep            # noqa: E402

import repro_torch.models as port_models                    # noqa: E402
from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.models import encdec, layers, transformer, vlm  # noqa: E402
from repro_torch.optim import AdamWConfig, opt_state_specs  # noqa: E402
from repro_torch.train import train_state_specs             # noqa: E402
from repro_torch.train.step import StepConfig               # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_defs(cfg):
    mod = (r_encdec if cfg.encdec is not None else
           r_vlm if cfg.vlm is not None else r_transformer)
    return mod.param_defs(cfg)


def _port_defs(cfg):
    mod = (encdec if cfg.encdec is not None else
           vlm if cfg.vlm is not None else transformer)
    return mod.param_defs(cfg)


def _is_dims(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _is_abstract(x):
    return isinstance(x, (jax.ShapeDtypeStruct, torch.Tensor))


def _plain(tree, is_leaf):
    """A spec or abstract tree as plain data: NamedTuples as {"type":
    name, **fields}, sequences as lists, abstract leaves as (shape,
    dtype name)."""
    if is_leaf(tree):
        if _is_abstract(tree):
            return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
        return tuple(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _plain(v, is_leaf) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {"type": type(tree).__name__,
                **{f: _plain(getattr(tree, f), is_leaf)
                   for f in tree._fields}}
    return [_plain(v, is_leaf) for v in tree]


def _one_layer(tree, is_leaf):
    """A stacked group's tree with the leading ``layers`` axis cut."""
    if is_leaf(tree):
        if _is_abstract(tree):
            return jax.ShapeDtypeStruct(tree.shape[1:], tree.dtype)
        assert tree[0] == "layers", tree
        return tuple(tree[1:])
    if isinstance(tree, dict):
        return {k: _one_layer(v, is_leaf) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_one_layer(v, is_leaf) for v in tree])
    return [_one_layer(v, is_leaf) for v in tree]


def _port_layout(cfg, tree, is_leaf):
    """The reference's param tree in the port's layout."""
    if cfg.encdec is not None:
        out = {k: v for k, v in tree.items() if k not in ("enc", "dec")}
        out["enc"] = [_one_layer(tree["enc"], is_leaf)] * \
            cfg.encdec.n_enc_layers
        out["dec"] = [_one_layer(tree["dec"], is_leaf)] * cfg.n_layers
        return out
    out = {k: v for k, v in tree.items()
           if k not in ("head_blocks", "groups", "tail_blocks")}
    out["layers"] = _layers(cfg, tree.get("head_blocks", []),
                            tree.get("groups", {}),
                            tree.get("tail_blocks", []), is_leaf)
    return out


def _layers(cfg, head, groups, tail, is_leaf):
    _, pat, n_groups, _ = transformer.layer_plan(cfg)
    body = [_one_layer(groups[f"p{j}"], is_leaf)
            for _ in range(n_groups) for j in range(len(pat))]
    return list(head) + body + list(tail)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_abstract_params(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    defs, rdefs = _port_defs(cfg), _ref_defs(rcfg)
    want = _port_layout(cfg, r_layers.param_specs(rdefs), _is_dims)
    got = port_models.param_specs(defs)
    assert _plain(got, _is_dims) == _plain(want, _is_dims)
    for dtype, rdtype in ((None, None), (torch.float32, "float32")):
        kw = {} if dtype is None else {"dtype": dtype}
        rkw = {} if rdtype is None else {"dtype": rdtype}
        got = port_models.abstract_params(defs, **kw)
        assert all(t.device.type == "meta" for t in
                   jax.tree.leaves(got, is_leaf=_is_abstract)
                   if isinstance(t, torch.Tensor))
        want = _port_layout(cfg, r_layers.abstract_params(rdefs, **rkw),
                            _is_abstract)
        assert _plain(got, _is_abstract) == _plain(want, _is_abstract)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    if cfg.encdec is not None:
        got = encdec.dec_cache_specs(cfg)
        want = [_one_layer(r_encdec.dec_cache_specs(rcfg), _is_dims)] * \
            cfg.n_layers
    else:
        got = transformer.cache_specs(cfg, 4, 256)
        ref = r_transformer.cache_specs(rcfg, 4, 256)
        want = _layers(cfg, ref.get("head", []), ref.get("groups", {}),
                       ref.get("tail", []), _is_dims)
    assert len(got) == (cfg.n_layers if cfg.encdec is not None
                        else len(transformer.layer_kinds(cfg)))
    assert _plain(got, _is_dims) == _plain(want, _is_dims)


@pytest.mark.parametrize("use_master", [True, False])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "whisper-base"])
def test_opt_and_train_state_specs(arch, use_master, compress):
    cfg, rcfg = get_config(arch), ref_config(arch)
    specs = port_models.param_specs(_port_defs(cfg))
    rspecs = r_layers.param_specs(_ref_defs(rcfg))
    lay = lambda t: None if t is None else _port_layout(  # noqa: E731
        cfg, t, _is_dims)
    opt = opt_state_specs(specs, AdamWConfig(use_master=use_master))
    ropt = r_opt_specs(rspecs, RAdamW(use_master=use_master))
    want = ropt._replace(mu=lay(ropt.mu), nu=lay(ropt.nu),
                         master=lay(ropt.master))
    assert _plain(opt, _is_dims) == _plain(want, _is_dims)
    st = train_state_specs(cfg, specs, StepConfig(
        opt=AdamWConfig(use_master=use_master), compress_grads=compress))
    rst = r_train_specs(rcfg, rspecs, RStep(
        opt=RAdamW(use_master=use_master), compress_grads=compress))
    rst = rst._replace(
        params=lay(rst.params),
        opt=rst.opt._replace(mu=lay(rst.opt.mu), nu=lay(rst.opt.nu),
                             master=lay(rst.opt.master)),
        ef=None if rst.ef is None else rst.ef._replace(
            residual=lay(rst.ef.residual)))
    assert _plain(st, _is_dims) == _plain(rst, _is_dims)


def test_packages_bind_the_mesh_helpers():
    import repro_torch.optim
    import repro_torch.train
    assert port_models.param_specs is layers.param_specs
    assert port_models.abstract_params is layers.abstract_params
    assert repro_torch.optim.opt_state_specs is opt_state_specs
    assert repro_torch.train.train_state_specs is train_state_specs


def _child_env():
    """The port on the path and no card: the meshes these CPU tests build
    are cpu meshes on any machine."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _child(code: str) -> str:
    env = _child_env()
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


_ELASTIC = r"""
import tempfile
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.dist.sharding import NamedSharding, PartitionSpec
from repro_torch.launch.mesh import make_mesh

mesh = make_mesh((1,), ("data",))
try:
    tree = {"w": torch.arange(8.0), "n": torch.arange(3)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        sh = {"w": NamedSharding(mesh, PartitionSpec("data")), "n": None}
        got, _ = load_checkpoint(d, shardings=sh)
        assert isinstance(got["w"], DTensor)
        assert got["w"].placements == sh["w"].placements == (Shard(0),)
        np.testing.assert_array_equal(got["w"].full_tensor().numpy(),
                                      np.arange(8.0))
        assert type(got["n"]) is torch.Tensor and torch.equal(
            got["n"], torch.arange(3))
        # a DTensor leaf saves whole
        save_checkpoint(d, 2, got)
        again, _ = load_checkpoint(d, step=2)
        np.testing.assert_array_equal(again["w"], np.arange(8.0))
        for kw, exc in ((dict(device="cpu", shardings=sh), ValueError),
                        (dict(shardings={"w": "data", "n": None}),
                         TypeError)):
            try:
                load_checkpoint(d, **kw)
                raise SystemExit(f"load_checkpoint({kw}) ran")
            except exc:
                pass
    print("ELASTIC_OK")
finally:
    dist.destroy_process_group()
"""


def test_elastic_restore_onto_shardings():
    assert "ELASTIC_OK" in _child(_ELASTIC)


_TWO_RANKS = r"""
import sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
port, rank, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
try:
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.data import DataConfig
    from repro_torch.dist.sharding import (NamedSharding, PartitionSpec,
                                           tree_shardings)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ModelConfig, param_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim._tree import leaves
    from repro_torch.train import train_state_specs
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    from repro_torch.train.step import (StepConfig, init_train_state,
                                        make_train_step)

    # a checkpoint restored onto placements that split its tensors
    mesh = make_mesh((2,), ("data",))
    w = np.arange(48, dtype=np.float32).reshape(8, 6)
    v = np.arange(40, dtype=np.float32).reshape(4, 10)
    if rank == 0:
        save_checkpoint(d + "/tree", 1, {"w": torch.from_numpy(w),
                                         "v": torch.from_numpy(v)})
    dist.barrier()
    sh = {"w": NamedSharding(mesh, PartitionSpec("data", None)),
          "v": NamedSharding(mesh, PartitionSpec(None, "data"))}
    got, _ = load_checkpoint(d + "/tree", shardings=sh)
    assert got["w"].placements == (Shard(0),)
    assert got["v"].placements == (Shard(1),)
    assert torch.equal(got["w"].to_local(),
                       torch.from_numpy(w[4 * rank:4 * rank + 4]))
    assert torch.equal(got["v"].to_local(),
                       torch.from_numpy(v[:, 5 * rank:5 * rank + 5]))
    assert torch.equal(got["w"].full_tensor(), torch.from_numpy(w))
    assert torch.equal(got["v"].full_tensor(), torch.from_numpy(v))

    # a train state resumed onto fsdp shards over data=2 and stepped
    cfg = ModelConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
    data = DataConfig(vocab=256, seq_len=32, global_batch=4, kind="markov")
    sc = StepConfig(opt=AdamWConfig(lr=3e-3), warmup_steps=5,
                    total_steps=100)
    defs = T.param_defs(cfg)
    state = init_train_state(cfg, init_params(defs, 0, device="cpu"), sc)
    step = make_train_step(cfg, sc)
    mesh = make_mesh((2, 1), ("data", "model"))
    sh = tree_shardings(train_state_specs(cfg, param_specs(defs), sc),
                        state, mesh)
    ck = d + "/train"
    if rank == 0:
        train_loop(step, state, data, TrainLoopConfig(
            total_steps=3, ckpt_dir=ck, ckpt_every=3))
    dist.barrier()
    ref = train_loop(step, state, data, TrainLoopConfig(
        total_steps=5, ckpt_dir=ck, ckpt_every=100))
    out = train_loop(step, state, data, TrainLoopConfig(
        total_steps=5, ckpt_dir=ck, ckpt_every=100), state_shardings=sh)
    split = [x for x in leaves(out["state"].params)
             if any(isinstance(p, Shard) for p in x.placements)]
    assert split and all(x.to_local().numel() * 2 == x.numel()
                         for x in split)
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-6)
    for x, y in zip(leaves(out["state"]), leaves(ref["state"])):
        x = x.full_tensor() if isinstance(x, DTensor) else x
        assert x.dtype == y.dtype
        np.testing.assert_allclose(x.double().numpy(), y.double().numpy(),
                                   rtol=0, atol=1e-6)
    print("TWO_RANK_RESTORE_OK", rank)
finally:
    dist.destroy_process_group()
"""


def test_restore_onto_shards_split_over_two_ranks(tmp_path):
    """A checkpoint restored onto ``Shard(0)`` and ``Shard(1)`` over two
    gloo ranks: each rank holds its slice, ``full_tensor`` gives the
    saved value back.  A train state resumed onto fsdp shards over
    data=2 steps within 1e-6 of the unsharded resume: the split
    products sum their halves in another order, so not bitwise."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = _child_env()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_RANKS, str(port), str(r), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
            f"{se[-3000:]}"
        assert f"TWO_RANK_RESTORE_OK {r}" in so


_RESUME = r"""
import tempfile
import numpy as np, torch
torch.set_num_threads(2)
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.data import DataConfig
from repro_torch.dist.sharding import NamedSharding, tree_shardings
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ModelConfig, param_specs
from repro_torch.models import transformer as T
from repro_torch.models.layers import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.optim._tree import leaves
from repro_torch.train import train_state_specs
from repro_torch.train.loop import TrainLoopConfig, train_loop
from repro_torch.train.step import StepConfig, init_train_state, \
    make_train_step

cfg = ModelConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
data = DataConfig(vocab=256, seq_len=32, global_batch=4, kind="markov")
sc = StepConfig(opt=AdamWConfig(lr=3e-3), compress_grads=True,
                warmup_steps=5, total_steps=100)
defs = T.param_defs(cfg)
state = init_train_state(cfg, init_params(defs, 0, device="cpu"), sc)
step = make_train_step(cfg, sc)
mesh = make_host_mesh()
try:
    sh = tree_shardings(train_state_specs(cfg, param_specs(defs), sc),
                        state, mesh)
    with tempfile.TemporaryDirectory() as d:
        train_loop(step, state, data, TrainLoopConfig(
            total_steps=3, ckpt_dir=d, ckpt_every=3))
        ref = train_loop(step, state, data, TrainLoopConfig(
            total_steps=6, ckpt_dir=d, ckpt_every=100))
        out = train_loop(step, state, data, TrainLoopConfig(
            total_steps=6, ckpt_dir=d, ckpt_every=100), state_shardings=sh)
    np.testing.assert_array_equal(out["losses"], ref["losses"])
    got = leaves(out["state"])
    assert all(isinstance(x, DTensor) for x in got[:-1])
    def sh_leaves(t):
        if isinstance(t, NamedSharding):
            return [t]
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in sh_leaves(t[k])]
        return [x for v in t for x in sh_leaves(v)]
    placed = sh_leaves(sh.params)
    assert len(placed) == len(leaves(state.params))
    for x, s in zip(leaves(out["state"].params), placed):
        assert x.placements == s.placements
    assert type(out["state"].rng) is torch.Tensor
    assert out["state"].rng.device.type == "cpu"
    for x, y in zip(got, leaves(ref["state"])):
        x = x.full_tensor() if isinstance(x, DTensor) else x
        assert x.dtype == y.dtype and torch.equal(x, y)
    print("RESUME_OK")
finally:
    dist.destroy_process_group()
"""


def test_train_loop_resumes_onto_shardings_bitwise():
    assert "RESUME_OK" in _child(_RESUME)
