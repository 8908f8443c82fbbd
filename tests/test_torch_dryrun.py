"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``tests/test_dryrun.py``), on the CPU.

  * the reference test's seven (arch, shape) pairs at its TINY shapes,
    built and traced on a world of one: the FLOP count is > 0, the
    donated arguments are the reference's;
  * ``collective_stats`` over recorded events reproduces the reference
    parser's figures on its test's HLO lines, and the counter records
    the collectives DTensor issues;
  * ``_with_groups`` gives the reference's probe configs for every arch;
  * in a child on torch's ``fake`` backend, at full width on 256 and 512
    ranks: every argument leaf's local shape is the reference's
    ``NamedSharding(AbstractMesh(...), pspec).shard_shape`` (full depth),
    ``argument_size_in_bytes`` is their sum, and the outputs' global
    shapes are the reference's ``jax.eval_shape`` of the same step (one
    pattern group deep: the layers do not change them; traced on 256
    ranks, and mixtral-8x22b decode_32k on both meshes); a known
    product [B, D] x [D, F], F split 16 ways, counts 2 B D F / 16 FLOPs
    a rank.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

jax.devices()          # jax starts with one device before the import below
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun               # noqa: E402
if _FLAGS is None:     # the reference module writes XLA_FLAGS at import
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

import repro.dist                                           # noqa: E402,F401
from jax.sharding import AbstractMesh                       # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding    # noqa: E402
from repro.configs import ARCHS                             # noqa: E402
from repro.configs import get_config as get_config_R        # noqa: E402
from repro.configs import get_smoke_config as smoke_R      # noqa: E402
from repro.dist.sharding import DEFAULT_RULES as REF_RULES  # noqa: E402
from repro.dist.sharding import pspec as ref_pspec          # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun                       # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [("qwen2.5-32b", "train_4k"), ("gemma2-27b", "prefill_32k"),
         ("mixtral-8x22b", "decode_32k"), ("falcon-mamba-7b", "long_500k"),
         ("whisper-base", "decode_32k"), ("internvl2-26b", "train_4k"),
         ("recurrentgemma-9b", "decode_32k")]
#: the reference test's shrunken shape cells (seq_len, global_batch)
TINY = {"train_4k": (64, 4, "train"), "prefill_32k": (64, 2, "prefill"),
        "decode_32k": (64, 2, "decode"), "long_500k": (128, 1, "decode")}
SIZES = {256: ((16, 16), ("data", "model")),
         512: ((2, 16, 16), ("pod", "data", "model"))}


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("XLA_FLAGS", None)
    return env


def _start(src: str, *argv):
    return subprocess.Popen([sys.executable, "-c", src, *argv],
                            env=_child_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _join(proc, timeout=900) -> dict:
    try:
        so, se = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, se[-4000:]
    line = [ln for ln in so.splitlines() if ln.startswith("OUT ")]
    return json.loads(line[-1][4:])


@pytest.fixture(scope="module")
def children():
    """Both children, started together (each is one process)."""
    return {"tiny": _start(_TINY_CHILD, json.dumps(PAIRS), json.dumps(TINY)),
            "full": _start(_FULL_CHILD, json.dumps(PAIRS))}


# ---------------------------------------------------------------------------
# the TINY cells on a world of one
# ---------------------------------------------------------------------------

_TINY_CHILD = r"""
import json, sys
from repro_torch.configs import common, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh

pairs, tiny = json.loads(sys.argv[1]), json.loads(sys.argv[2])
for k, (seq, batch, step) in tiny.items():
    common.SHAPES[k] = common.ShapeCell(k, seq, batch, step)
dryrun._fake_world(1)
mesh = make_host_mesh()
out = {}
for arch, shape in pairs:
    cfg = get_smoke_config(arch)
    fn, args, donate = dryrun.build_cell(cfg, shape, mesh)
    rec = dryrun._trace_cell(cfg, shape, mesh)
    out[f"{arch}/{shape}"] = {"donate": list(donate), "n_args": len(args),
                              "flops": rec["flops"],
                              "memory": rec["memory"]}
print("OUT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def tiny_records(children):
    return _join(children["tiny"])


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_build_and_trace_cell(tiny_records, arch, shape, monkeypatch):
    from repro.configs import common as cfg_common
    for k, (seq, batch, step) in TINY.items():
        monkeypatch.setitem(cfg_common.SHAPES, k,
                            cfg_common.ShapeCell(k, seq, batch, step))
    rec = tiny_records[f"{arch}/{shape}"]
    assert rec["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with jax.set_mesh(mesh):
        _, args, donate = ref_dryrun.build_cell(smoke_R(arch), shape, mesh)
    assert rec["donate"] == list(donate)
    assert rec["n_args"] == len(args)


# ---------------------------------------------------------------------------
# collectives, probes
# ---------------------------------------------------------------------------

#: the reference test's HLO lines, as (kind, dtype, shape) events
_HLO = """
  %all-reduce.1 = bf16[8,128] all-reduce(bf16[8,128] %x)
  %ag = f32[64] all-gather(f32[32] %y)
  %rs.2 = f32[16,4]{1,0} reduce-scatter(f32[64,4] %z)
  %notacollective = f32[2] add(f32[2] %a, f32[2] %b)
  %cp-start = u32[4] collective-permute-start(u32[4] %w)
"""
_EVENTS = [("all-reduce", torch.bfloat16, (8, 128)),
           ("all-gather", torch.float32, (64,)),
           ("reduce-scatter", torch.float32, (16, 4)),
           ("collective-permute", torch.uint32, (4,))]


def test_collective_stats_matches_reference_parser():
    want = ref_dryrun.collective_stats(_HLO)
    got = dryrun.collective_stats(_EVENTS)
    assert got == want
    assert got["total_bytes"] == 8 * 128 * 2 + 256 + 256 + 16


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_with_groups_probe_configs(arch, k):
    want = ref_dryrun._with_groups(get_config_R(arch), k)
    got = dryrun._with_groups(get_config(arch), k)
    assert got.n_layers == want.n_layers
    assert got.scan_layers is want.scan_layers is False
    if want.encdec is not None:
        assert got.encdec.n_enc_layers == want.encdec.n_enc_layers == k
    cfg = get_smoke_config("gemma2-27b")        # pattern period 2
    assert dryrun._with_groups(cfg, 2).n_layers == 4


# ---------------------------------------------------------------------------
# full width on 256 and 512 fake ranks
# ---------------------------------------------------------------------------

_FULL_CHILD = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.configs import get_config
from repro_torch.dist.sharding import set_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

pairs = json.loads(sys.argv[1])
out = {}

def flat_dims(tree, spec):
    if isinstance(tree, torch.Tensor):
        return [spec]
    if isinstance(tree, dict):
        return [d for k in tree for d in flat_dims(tree[k], spec[k])]
    if tree is None:
        return []
    return [d for t, s in zip(tree, spec) for d in flat_dims(t, s)]

for world, multi in ((256, False), (512, True)):
    dryrun._fake_world(world)
    mesh = make_production_mesh(multi_pod=multi)
    for arch, shape in pairs:
        cfg = get_config(arch)
        key = f"{world}/{arch}/{shape}"
        rec = {}
        with set_mesh(None):
            _, abs_args, dims, _ = dryrun.abstract_cell(
                dryrun._dryrun_config(cfg), shape)
        with FakeTensorMode(allow_non_fake_inputs=True):
            _, args, _ = dryrun.build_cell(cfg, shape, mesh)
            leaves = list(dryrun._tensors(args))
            rec["leaves"] = [
                [d if d is None else list(d), list(t.shape),
                 list(dryrun._local(t).shape), t.element_size()]
                for t, d in zip(leaves, flat_dims(args, dims))]
            rec["arg_bytes"] = sum(dryrun._local(t).numel()
                                   * t.element_size() for t in leaves)
        train = shape == "train_4k"
        if world == 256 or arch == "mixtral-8x22b":
            probe = dryrun._with_groups(cfg, 1)
            res = []
            r = dryrun._trace_cell(probe, shape, mesh, outputs=res)
            first = res[0][1] if train else res[0][0]
            if train:
                rec["out"] = {k: list(v.shape) for k, v in first.items()}
            else:
                rec["out"] = list(first.shape)
                rec["out_dtype"] = str(first.dtype)
            with FakeTensorMode(allow_non_fake_inputs=True), \
                    set_mesh(mesh):
                _, pa, _ = dryrun.build_cell(probe, shape, mesh)
                probe_bytes = sum(dryrun._local(t).numel() * t.element_size()
                                  for t in dryrun._tensors(pa))
            rec["probe_arg_bytes"] = probe_bytes
            rec["probe_record"] = r
        out[key] = rec
    if world == 256:
        counter = dryrun._LocalCounter()
        B, D, F = 64, 256, 1024
        with FakeTensorMode(), set_mesh(mesh):
            x = DTensor.from_local(torch.zeros(B, D), mesh,
                                   [Replicate(), Replicate()],
                                   run_check=False)
            w = DTensor.from_local(torch.zeros(D, F // 16), mesh,
                                   [Replicate(), Shard(1)], run_check=False,
                                   shape=(D, F), stride=(F, 1))
            y = DTensor.from_local(torch.zeros(B // 16, D), mesh,
                                   [Shard(0), Replicate()], run_check=False,
                                   shape=(B, D), stride=(D, 1))
            with counter:
                x @ w
                flops = counter.flops
                y.redistribute(mesh, [Replicate(), Replicate()])
        out["product"] = {"flops": flops, "want": 2 * B * D * F // 16,
                          "stats": dryrun.collective_stats(counter.events),
                          "gathered": B * D * 4}
print("OUT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def full_records(children):
    return _join(children["full"])


def _ref_shard_shape(dims, shape, world):
    sizes, names = SIZES[world]
    amesh = AbstractMesh(sizes, names)
    dims = tuple(dims) if dims is not None else (None,) * len(shape)
    spec = ref_pspec(dims, tuple(shape), REF_RULES, amesh)
    return tuple(JNamedSharding(amesh, spec).shard_shape(tuple(shape)))


@pytest.mark.parametrize("world", [256, 512])
@pytest.mark.parametrize("arch,shape", PAIRS)
def test_argument_shards_are_the_reference_rules(full_records, arch, shape,
                                                 world):
    rec = full_records[f"{world}/{arch}/{shape}"]
    total = 0
    assert len(rec["leaves"]) > 0
    for dims, glob, local, size in rec["leaves"]:
        want = _ref_shard_shape(dims, glob, world)
        assert tuple(local) == want, (dims, glob, local, want)
        total += math.prod(want) * size
    assert rec["arg_bytes"] == total
    if "probe_record" in rec:
        mem = rec["probe_record"]["memory"]
        assert mem["argument_size_in_bytes"] == rec["probe_arg_bytes"]
        assert rec["probe_record"]["flops"] > 0


def _ref_out(arch, shape):
    """The reference step's first output (logits) or its metrics under
    jax.eval_shape, one pattern group deep."""
    from repro.models import encdec, transformer, vlm
    from repro.models.layers import abstract_params
    from repro.configs import SHAPES, input_specs
    cfg = ref_dryrun._with_groups(get_config_R(arch), 1)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    cell = SHAPES[shape]
    defs = ref_dryrun._model_defs(cfg)
    p = abstract_params(defs, jnp.bfloat16)
    batch = input_specs(cfg, shape)
    if cell.step == "train":
        from repro.optim import AdamWConfig
        from repro.train.step import (StepConfig, init_train_state,
                                      make_train_step)
        sc = StepConfig(opt=AdamWConfig(use_master=True))
        st = jax.eval_shape(lambda q: init_train_state(cfg, q, sc), p)
        _, metrics = jax.eval_shape(make_train_step(cfg, sc), st, batch)
        return {k: list(v.shape) for k, v in metrics.items()}
    if cell.step == "prefill":
        out = jax.eval_shape(lambda q, b: transformer.prefill(
            q, cfg, b["tokens"], cell.seq_len), p, batch)
        return list(out[0].shape), str(out[0].dtype)
    b = cell.global_batch
    if cfg.encdec is not None:
        caches = jax.eval_shape(lambda: encdec.init_dec_caches(
            cfg, b, cell.seq_len, jnp.bfloat16))
        enc = jax.ShapeDtypeStruct((b, cfg.encdec.enc_seq, cfg.d_model),
                                   jnp.bfloat16)
        out = jax.eval_shape(lambda q, t, e, c: encdec.decode_step(
            q, cfg, t, e, c, jnp.asarray(cell.seq_len - 1, jnp.int32)),
            p, batch["token"], enc, caches)
    else:
        caches = jax.eval_shape(lambda: transformer.init_caches(
            cfg, b, cell.seq_len, jnp.bfloat16))
        out = jax.eval_shape(lambda q, t, c: transformer.decode_step(
            q, cfg, t, c, jnp.asarray(cell.seq_len - 1, jnp.int32)),
            p, batch["token"], caches)
    return list(out[0].shape), str(out[0].dtype)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_output_shapes_are_the_reference_step(full_records, arch, shape):
    want = _ref_out(arch, shape)
    worlds = [256, 512] if arch == "mixtral-8x22b" else [256]
    for world in worlds:
        rec = full_records[f"{world}/{arch}/{shape}"]
        if shape == "train_4k":
            assert rec["out"] == want
        else:
            assert rec["out"] == want[0]
            assert rec["out_dtype"] == "torch." + want[1]


def test_mixtral_decode_traces_on_both_meshes(full_records):
    for world in (256, 512):
        rec = full_records[f"{world}/mixtral-8x22b/decode_32k"]
        assert rec["probe_record"]["flops"] > 0
        assert rec["probe_record"]["collectives"]["total_bytes"] > 0


def test_flops_are_counted_per_rank(full_records):
    rec = full_records["product"]
    assert rec["flops"] == rec["want"] == 2 * 64 * 256 * 1024 // 16
    assert rec["stats"]["all-gather"] == {"count": 1,
                                          "bytes": rec["gathered"]}
