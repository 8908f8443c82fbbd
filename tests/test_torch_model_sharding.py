"""The models' ``shard(...)`` calls (the reference's 24 constraints, in
``repro_torch.models``) and the sharded model path, on the CPU.

  * outside a mesh every model function changed for the mesh is bitwise
    what it was: prefill and decode logits, the loss and every cache
    leaf of each family's smoke config (seeded weights) hash to the
    digests the port gave before its models made any ``shard`` call;
  * on a fake 16 x 16 world (torch's ``fake`` backend, 256 ranks, every
    tensor a ``FakeTensorMode`` one), a hook records each ``shard`` call's
    logical dims, shape and layout for each family's prefill, decode
    step and loss; they equal the calls the reference makes under
    ``jax.eval_shape`` (its models' ``shard`` names monkeypatched to
    record), but that the port's chunked SSM scan loops over its chunks
    where the reference's ``lax.scan`` traces the chunk body once;
  * two gloo ranks on a (1, 2) ("data", "model") mesh run the dense,
    MoE (one-hot and sort dispatch), SSM and RG-LRU smoke configs on the
    reference's weights, laid out by ``tree_shardings``: prefill logits,
    one decode step and the loss are within 1e-4 of the reference's,
    relative to the largest, as the unsharded port is.
"""

import dataclasses
import hashlib
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402
import repro.dist                                           # noqa: E402,F401
from jax.sharding import AbstractMesh                       # noqa: E402
from repro.configs import get_smoke_config as smoke_R      # noqa: E402
from repro.dist.sharding import DEFAULT_RULES as REF_RULES  # noqa: E402
from repro.dist.sharding import pspec as ref_pspec          # noqa: E402

from _torch_families import close, models                   # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# outside a mesh: bitwise what it was
# ---------------------------------------------------------------------------

#: sha256 (first 16 hex digits) of (prefill logits, decode logits, loss,
#: every cache leaf) of each smoke config on the CPU, float32, weights
#: ``init_params(defs, 0)``, as the port computed them before its models
#: made any ``shard`` call (one thread or many: the same bits)
DIGESTS = {
    "phi3-medium-14b": ["2282599df7f54489", "b5a840c0eeff8ace",
                        "d0a20099486020a9", "1b1c17f6865a8225"],
    "gemma2-27b": ["7b52e2db91afd61d", "efa10896c332799f",
                   "918f5ee83f6d084d", "86c2c1a32e60f28a"],
    "deepseek-moe-16b": ["78c753379d5d4842", "f80a75ca52c85e6c",
                         "d2abd4147c2ad957", "989222299aea2aae"],
    "mixtral-8x22b": ["5fb58aad03ce624a", "ebf7364eee010ca6",
                      "6b32d9084556dc08", "6c626013ab427e1c"],
    "falcon-mamba-7b": ["c36e856608028128", "dcc4ecc5c3d3511a",
                        "f80a659ff59223f5", "f5a163a781e9a123"],
    "recurrentgemma-9b": ["b6fc6f80e6528a3c", "497d71f973e24bfd",
                          "1e42d0f8ed66f28e", "550d7140c97147fd"],
    "whisper-base": ["594f7d8de36671bd", "8d905fe86e1e32cf",
                     "31906f856eff4765"],
    "internvl2-26b": ["35698fce7c27bef0", "94572b66ca14b716",
                      "d2a43436260c6f1d"],
}


def _digest(*ts) -> str:
    m = hashlib.sha256()
    for t in ts:
        m.update(t.detach().contiguous().numpy().tobytes())
    return m.hexdigest()[:16]


def _smoke_port(arch):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    if arch == "falcon-mamba-7b":      # 16 tokens in chunks of 8
        cfg = dataclasses.replace(cfg, ssm_chunk=8)
    return cfg


@pytest.mark.parametrize("arch", sorted(DIGESTS))
def test_outside_a_mesh_bitwise_what_it_was(arch):
    from repro_torch.models import encdec, transformer, vlm
    from repro_torch.models.layers import init_params
    from repro_torch.dist.sharding import ambient_mesh
    assert ambient_mesh() is None
    cfg = _smoke_port(arch)
    g = torch.Generator().manual_seed(3)
    pos = torch.tensor(16, dtype=torch.int32)
    if cfg.encdec is not None:
        params = init_params(encdec.param_defs(cfg), 0, device="cpu")
        frames = torch.randn((2, cfg.encdec.enc_seq, cfg.d_model),
                             generator=g)
        toks = torch.randint(2, cfg.vocab, (2, 16), generator=g,
                             dtype=torch.int32)
        with torch.no_grad():
            lg, caches, enc = encdec.prefill(params, cfg, frames, toks, 32)
            lg2, caches = encdec.decode_step(params, cfg, toks[:, :1], enc,
                                             caches, pos)
        loss, _ = encdec.loss_fn(params, cfg, frames, toks, toks)
        got = [_digest(lg), _digest(lg2), _digest(loss)]
    elif cfg.vlm is not None:
        params = init_params(vlm.param_defs(cfg), 0, device="cpu")
        p = cfg.vlm.n_patches
        patches = torch.randn((2, p, cfg.vlm.vit_dim), generator=g)
        toks = torch.randint(2, cfg.vocab, (2, 16), generator=g,
                             dtype=torch.int32)
        labels = torch.randint(2, cfg.vocab, (2, p + 16), generator=g,
                               dtype=torch.int32)
        with torch.no_grad():
            lg, caches = vlm.prefill(params, cfg, patches, toks, p + 32)
            lg2, caches = transformer.decode_step(
                params, cfg, toks[:, :1], caches,
                torch.tensor(p + 16, dtype=torch.int32))
        loss, _ = vlm.loss_fn(params, cfg, patches, toks, labels)
        got = [_digest(lg), _digest(lg2), _digest(loss)]
    else:
        params = init_params(transformer.param_defs(cfg), 0, device="cpu")
        toks = torch.randint(2, cfg.vocab, (2, 16), generator=g,
                             dtype=torch.int32)
        with torch.no_grad():
            lg, caches = transformer.prefill(params, cfg, toks, 32)
            lg2, caches = transformer.decode_step(params, cfg, toks[:, :1],
                                                  caches, pos)
        loss, _ = transformer.loss_fn(params, cfg, toks, toks)
        got = [_digest(lg), _digest(lg2), _digest(loss),
               _digest(*[x for c in caches for x in c])]
    assert got == DIGESTS[arch]


# ---------------------------------------------------------------------------
# the shard calls on a fake 16 x 16 world, against the reference's
# ---------------------------------------------------------------------------

#: (arch, overrides) whose shard calls are compared: every family, the
#: MoE's both dispatches and the gathered tokens, the SSM's chunked scan
RECORDED = {
    "phi3-medium-14b": {},
    "gemma2-27b": {},
    "deepseek-moe-16b": {},
    "mixtral-8x22b": {},
    "falcon-mamba-7b": {"ssm_chunk": 8},
    "recurrentgemma-9b": {},
    "whisper-base": {},
    "internvl2-26b": {},
}
B, T, MAX = 32, 16, 32
_REF_MODULES = ("layers", "transformer", "attention", "moe", "ssm",
                "rglru", "encdec", "vlm")


def _ref_calls(arch, step):
    """The reference's shard calls [(dims, shape, spec)] for one step of
    the smoke config (unrolled layers, no remat) under jax.eval_shape,
    each module's ``shard`` name recording."""
    import importlib
    from repro.models import encdec, transformer, vlm
    from repro.models.layers import abstract_params
    cfg = dataclasses.replace(smoke_R(arch), scan_layers=False,
                              remat="none", **RECORDED[arch])
    amesh = AbstractMesh((16, 16), ("data", "model"))
    calls = []

    def rec(x, *dims):
        spec = ref_pspec(dims, x.shape, REF_RULES, amesh)
        calls.append([list(map(_dim, dims)), list(x.shape),
                      [_dim(e) for e in spec]])
        return x

    mods = [importlib.import_module(f"repro.models.{m}")
            for m in _REF_MODULES]
    saved = [m.shard for m in mods]
    for m in mods:
        m.shard = rec
    try:
        f32 = jnp.float32
        tok = jax.ShapeDtypeStruct((B, T), jnp.int32)
        if cfg.encdec is not None:
            params = abstract_params(encdec.param_defs(cfg), f32)
            frames = jax.ShapeDtypeStruct((B, cfg.encdec.enc_seq,
                                           cfg.d_model), f32)
            if step == "prefill":
                jax.eval_shape(lambda p, f, t: encdec.prefill(
                    p, cfg, f, t, MAX), params, frames, tok)
            elif step == "decode":
                enc = jax.ShapeDtypeStruct((B, cfg.encdec.enc_seq,
                                            cfg.d_model), f32)
                caches = jax.eval_shape(
                    lambda: encdec.init_dec_caches(cfg, B, MAX, f32))
                jax.eval_shape(lambda p, t, e, c: encdec.decode_step(
                    p, cfg, t, e, c, jnp.asarray(T, jnp.int32)),
                    params, jax.ShapeDtypeStruct((B, 1), jnp.int32), enc,
                    caches)
            else:
                jax.eval_shape(lambda p, f, t: encdec.loss_fn(
                    p, cfg, f, t, t), params, frames, tok)
            return calls
        if cfg.vlm is not None:
            params = abstract_params(vlm.param_defs(cfg), f32)
            npch = cfg.vlm.n_patches
            patches = jax.ShapeDtypeStruct((B, npch, cfg.vlm.vit_dim), f32)
            if step == "prefill":
                jax.eval_shape(lambda p, a, t: vlm.prefill(
                    p, cfg, a, t, npch + MAX), params, patches, tok)
            elif step == "decode":
                caches = jax.eval_shape(lambda: transformer.init_caches(
                    cfg, B, npch + MAX, f32))
                jax.eval_shape(lambda p, t, c: transformer.decode_step(
                    p, cfg, t, c, jnp.asarray(npch + T, jnp.int32)),
                    params, jax.ShapeDtypeStruct((B, 1), jnp.int32), caches)
            else:
                labels = jax.ShapeDtypeStruct((B, npch + T), jnp.int32)
                jax.eval_shape(lambda p, a, t, lab: vlm.loss_fn(
                    p, cfg, a, t, lab), params, patches, tok, labels)
            return calls
        params = abstract_params(transformer.param_defs(cfg), f32)
        if step == "prefill":
            jax.eval_shape(lambda p, t: transformer.prefill(
                p, cfg, t, MAX), params, tok)
        elif step == "decode":
            caches = jax.eval_shape(lambda: transformer.init_caches(
                cfg, B, MAX, f32))
            jax.eval_shape(lambda p, t, c: transformer.decode_step(
                p, cfg, t, c, jnp.asarray(T, jnp.int32)),
                params, jax.ShapeDtypeStruct((B, 1), jnp.int32), caches)
        else:
            jax.eval_shape(lambda p, t: transformer.loss_fn(
                p, cfg, t, t), params, tok)
        return calls
    finally:
        for m, s in zip(mods, saved):
            m.shard = s


def _dim(e):
    return list(e) if isinstance(e, tuple) else e


_RECORD_CHILD = r"""
import dataclasses, importlib, json, sys
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_smoke_config
from repro_torch.dist import sharding as S
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import encdec, transformer, vlm
from repro_torch.models.layers import abstract_params, param_specs

RECORDED = json.loads(sys.argv[1])
B, T, MAX = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
MODULES = ("layers", "transformer", "attention", "moe", "ssm", "rglru",
           "encdec", "vlm")
dryrun._fake_world(256)
mesh = make_production_mesh()
calls = []

def dim(e):
    return list(e) if isinstance(e, tuple) else e

def rec(x, *dims):
    y = S.shard(x, *dims)
    sh = S.logical_sharding(dims, tuple(x.shape), mesh)
    assert tuple(y.placements) == tuple(sh.placements), (dims, y.placements)
    calls.append([[dim(d) for d in dims], list(x.shape),
                  [dim(e) for e in sh.spec]])
    return y

mods = [importlib.import_module(f"repro_torch.models.{m}") for m in MODULES]
for m in mods:
    m.shard = rec

def leaf(shape, dims, dtype=torch.float32):
    return dryrun._fake_leaf(torch.empty(shape, dtype=dtype, device="meta"),
                             dims, mesh)

def placed(tree, specs):
    return dryrun._sharded_abstract(tree, specs, mesh)

out = {}
with FakeTensorMode(allow_non_fake_inputs=True):
    for arch, over in RECORDED.items():
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        with S.set_mesh(None):
            if cfg.encdec is not None:
                defs = encdec.param_defs(cfg)
            elif cfg.vlm is not None:
                defs = vlm.param_defs(cfg)
            else:
                defs = transformer.param_defs(cfg)
            params = placed(abstract_params(defs, torch.float32),
                            param_specs(defs))
        tok = leaf((B, T), ("batch", None), torch.int32)
        one = leaf((B, 1), ("batch", None), torch.int32)
        for step in ("prefill", "decode", "loss"):
            del calls[:]
            with S.set_mesh(mesh), torch.no_grad():
                if cfg.encdec is not None:
                    frames = leaf((B, cfg.encdec.enc_seq, cfg.d_model),
                                  ("batch", None, None))
                    if step == "prefill":
                        encdec.prefill(params, cfg, frames, tok, MAX)
                    elif step == "decode":
                        with S.set_mesh(None):
                            c = placed(encdec.init_dec_caches(
                                cfg, B, MAX, torch.float32, "meta"),
                                encdec.dec_cache_specs(cfg))
                        encdec.decode_step(params, cfg, one, frames, c,
                                           torch.tensor(T, dtype=torch.int32))
                    else:
                        encdec.loss_fn(params, cfg, frames, tok, tok)
                elif cfg.vlm is not None:
                    npch = cfg.vlm.n_patches
                    patches = leaf((B, npch, cfg.vlm.vit_dim),
                                   ("batch", None, None))
                    if step == "prefill":
                        vlm.prefill(params, cfg, patches, tok, npch + MAX)
                    elif step == "decode":
                        with S.set_mesh(None):
                            c = placed(transformer.init_caches(
                                cfg, B, npch + MAX, torch.float32, "meta"),
                                transformer.cache_specs(cfg, B, npch + MAX))
                        transformer.decode_step(
                            params, cfg, one, c,
                            torch.tensor(npch + T, dtype=torch.int32))
                    else:
                        labels = leaf((B, npch + T), ("batch", None),
                                      torch.int32)
                        vlm.loss_fn(params, cfg, patches, tok, labels)
                else:
                    if step == "prefill":
                        transformer.prefill(params, cfg, tok, MAX)
                    elif step == "decode":
                        with S.set_mesh(None):
                            c = placed(transformer.init_caches(
                                cfg, B, MAX, torch.float32, "meta"),
                                transformer.cache_specs(cfg, B, MAX))
                        transformer.decode_step(
                            params, cfg, one, c,
                            torch.tensor(T, dtype=torch.int32))
                    else:
                        transformer.loss_fn(params, cfg, tok, tok)
            out[f"{arch}/{step}"] = list(calls)
dist.destroy_process_group()
print("CALLS " + json.dumps(out))
"""


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _start(*argv):
    return subprocess.Popen([sys.executable, "-c", *argv], env=_child_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _joined(proc, tag: str):
    """The JSON after ``tag`` on the child's stdout (it must succeed)."""
    try:
        so, se = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, se[-4000:]
    line = [ln for ln in so.splitlines() if ln.startswith(tag + " ")]
    return json.loads(line[-1][len(tag) + 1:])


@pytest.fixture(scope="module", autouse=True)
def children(tmp_path_factory):
    """Every child of the module, started together at its first test:
    the fake-world recorder, the world of one, and the two gloo ranks
    (on the reference's weights, written to a file first)."""
    procs = {"record": _start(_RECORD_CHILD, json.dumps(RECORDED), str(B),
                              str(T), str(MAX)),
             "one": _start(_ONE_CHILD, json.dumps(ONE))}
    job, refs = {}, {}
    for arch in PARITY:
        cfg_r, params_r, cfg_p, _ = models(arch, False)
        toks = np.random.RandomState(4).randint(
            2, cfg_r.vocab, (PB, PT)).astype(np.int32)
        job[arch] = (cfg_p, jax.tree.map(np.asarray, params_r), toks)
        refs[arch] = (cfg_r, params_r, toks)
    path = str(tmp_path_factory.mktemp("gloo") / "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    port = _free_port()
    procs["gloo"] = [_start(_GLOO_CHILD, str(port), str(r), path)
                     for r in range(2)]
    procs["gloo_job"] = (path, refs)
    yield procs
    for p in [procs["record"], procs["one"]] + procs["gloo"]:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def port_calls(children):
    return _joined(children["record"], "CALLS")


def _unroll_chunks(calls, arch):
    """The reference's calls with its chunk body's three calls (ssm.py:137,
    138, 145, traced once by ``lax.scan``) repeated once a chunk, as the
    port's loop makes them."""
    over = RECORDED[arch]
    if "ssm_chunk" not in over:
        return calls
    nc = T // over["ssm_chunk"]
    out, i = [], 0
    while i < len(calls):
        c = calls[i]
        out.append(c)
        # the stacked chunks (ssm.py:131-132) are 5-d; the body follows
        if len(c[1]) == 5 and i + 2 < len(calls) and len(calls[i + 1][1]) == 5:
            out.append(calls[i + 1])
            body = calls[i + 2:i + 5]
            out += body * nc
            i += 5
            continue
        i += 1
    return out


@pytest.mark.parametrize("step", ["prefill", "decode", "loss"])
@pytest.mark.parametrize("arch", sorted(RECORDED))
def test_shard_calls_match_reference(port_calls, arch, step):
    want = _unroll_chunks(_ref_calls(arch, step), arch)
    got = port_calls[f"{arch}/{step}"]
    assert len(want) > 0
    assert got == want


def test_every_reference_shard_call_has_a_counterpart():
    """24 ``shard(`` calls in the reference's models, 24 in the port's,
    each port call beside a comment naming its reference line."""
    import re
    def calls(pkg):
        n = 0
        d = os.path.join(ROOT, "src", pkg, "models")
        for f in sorted(os.listdir(d)):
            if f.endswith(".py"):
                for line in open(os.path.join(d, f)):
                    code = line.split("#")[0]
                    n += len(re.findall(r"(?<![\w.])shard\(", code))
        return n
    assert calls("repro") == calls("repro_torch") == 24
    d = os.path.join(ROOT, "src", "repro_torch", "models")
    tags = 0
    for f in sorted(os.listdir(d)):
        if f.endswith(".py"):
            tags += len(re.findall(r"# \w+\.py:\d+", open(
                os.path.join(d, f)).read()))
    assert tags >= 20


# ---------------------------------------------------------------------------
# two gloo ranks on a (1, 2) mesh against the reference
# ---------------------------------------------------------------------------

PARITY = ["phi3-medium-14b", "deepseek-moe-16b", "mixtral-8x22b",
          "falcon-mamba-7b", "recurrentgemma-9b"]
PB, PT, PMAX = 2, 12, 24

_GLOO_CHILD = r"""
import json, pickle, sys
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch import convert
from repro_torch.dist.sharding import set_mesh, tree_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.models.layers import param_specs
from repro_torch.optim._tree import leaves

port, rank, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
with open(path, "rb") as f:
    job = pickle.load(f)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
mesh = make_mesh((1, 2), ("data", "model"))

def walk(tree, shs):
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, shs.placements,
                                 src_data_rank=None)
    if isinstance(tree, dict):
        return {k: walk(v, shs[k]) for k, v in tree.items()}
    return [walk(v, s) for v, s in zip(tree, shs)]

def full(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).numpy()

out = {}
for arch, (cfg, tree, toks) in job.items():
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    shs = tree_shardings(param_specs(transformer.param_defs(cfg)), params,
                         mesh)
    params = walk(params, shs)
    toks = torch.from_numpy(toks)
    b, t = toks.shape
    with set_mesh(mesh):
        with torch.no_grad():
            lg, caches = transformer.prefill(params, cfg, toks, %(MAX)d)
            nxt = torch.from_numpy(full(lg)[:, -1].argmax(-1)
                                   .astype(np.int32)[:, None])
            lg2, caches = transformer.decode_step(
                params, cfg, nxt, caches, torch.tensor(t, dtype=torch.int32))
        loss, (ce, aux) = transformer.loss_fn(params, cfg, toks, toks)
    sharded = sum(any(not q.is_replicate() for q in p.placements)
                  for p in leaves(params))
    out[arch] = {"prefill": full(lg), "decode": full(lg2),
                 "next": nxt.numpy(), "loss": full(loss), "sharded": sharded}
if rank == 0:
    with open(path + ".out", "wb") as f:
        pickle.dump(out, f)
dist.destroy_process_group()
print("GLOO_OK", rank)
""" % {"MAX": PMAX}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_results(children):
    from repro.models import transformer as T_R
    path, refs = children["gloo_job"]
    for r, p in enumerate(children["gloo"]):
        try:
            so, se = p.communicate(timeout=600)
        finally:
            p.kill()
        assert p.returncode == 0, se[-4000:]
        assert f"GLOO_OK {r}" in so
    with open(path + ".out", "rb") as f:
        got = pickle.load(f)
    return got, refs, T_R


@pytest.mark.parametrize("arch", PARITY)
def test_two_gloo_ranks_match_reference(gloo_results, arch):
    got, refs, T_R = gloo_results
    cfg_r, params_r, toks = refs[arch]
    g = got[arch]
    assert g["sharded"] > 0          # some leaves split across "model"
    lr, cr = jax.jit(T_R.prefill, static_argnums=(1, 3))(
        params_r, cfg_r, jnp.asarray(toks), PMAX)
    close(g["prefill"], lr, 1e-4, f"{arch} prefill logits")
    nxt = np.asarray(lr)[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert np.array_equal(g["next"], nxt)
    lr2, _ = jax.jit(T_R.decode_step, static_argnums=1)(
        params_r, cfg_r, jnp.asarray(nxt), cr,
        jnp.asarray(PT, jnp.int32))
    close(g["decode"], lr2, 1e-4, f"{arch} decode logits")
    want, _ = jax.jit(T_R.loss_fn, static_argnums=1)(
        params_r, cfg_r, jnp.asarray(toks), jnp.asarray(toks))
    close(g["loss"], want, 1e-4, f"{arch} loss")


# ---------------------------------------------------------------------------
# a world of one: inside the mesh bitwise outside it
# ---------------------------------------------------------------------------

_ONE_CHILD = r"""
import dataclasses, json, sys
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_smoke_config
from repro_torch.dist.sharding import set_mesh, tree_shardings
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.models.layers import init_params, param_specs
from repro_torch.optim import AdamWConfig
from repro_torch.optim._tree import leaves
from repro_torch.train import step as S

mesh = make_host_mesh()

def placed(tree, shs):
    if isinstance(tree, torch.Tensor):
        return DTensor.from_local(tree, mesh, shs.placements, run_check=False)
    if isinstance(tree, dict):
        return {k: placed(v, shs[k]) for k, v in tree.items()}
    if tree is None:
        return None
    out = [placed(t, s) for t, s in zip(tree, shs)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)

def whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x

out = {}
for arch in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(get_smoke_config(arch), remat="full",
                              loss_chunk=8)
    defs = T.param_defs(cfg)
    params = init_params(defs, 0, dtype=torch.bfloat16, device="cpu")
    dparams = placed(params, tree_shardings(param_specs(defs), params, mesh))
    toks = torch.randint(2, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)

    def serve(p):
        lg, caches = T.prefill(p, cfg, toks, 32)
        outs = [whole(lg)]
        for i in range(3):
            cur = outs[-1][:, -1].argmax(-1).to(torch.int32)[:, None]
            lg, caches = T.decode_step(p, cfg, cur, caches,
                                       torch.tensor(24 + i, dtype=torch.int32))
            outs.append(whole(lg))
        return outs

    with torch.no_grad():
        a = serve(params)
        with set_mesh(mesh):
            b = serve(dparams)
    sc = S.StepConfig(opt=AdamWConfig(use_master=True))
    step = S.make_train_step(cfg, sc)
    state = S.init_train_state(cfg, params, sc)
    shs = tree_shardings(S.train_state_specs(cfg, param_specs(defs), sc)
                         ._replace(rng=None), state._replace(rng=None), mesh)
    dstate = placed(state._replace(rng=None), shs)._replace(rng=state.rng)
    batch = {"tokens": toks, "labels": toks}
    s0, m0 = step(state, batch)
    with set_mesh(mesh):
        s1, m1 = step(dstate, batch)
    out[arch] = {
        "serve": all(torch.equal(x, y) for x, y in zip(a, b)),
        "loss": torch.equal(m0["loss"], whole(m1["loss"])),
        "params": all(torch.equal(x, whole(y)) for x, y in
                      zip(leaves(s0.params), leaves(s1.params))),
        "opt": all(torch.equal(x, whole(y)) for x, y in
                   zip(leaves(s0.opt), leaves(s1.opt))),
        "dtensors": all(isinstance(p, DTensor) for p in leaves(s1.params))}
dist.destroy_process_group()
print("ONE " + json.dumps(out))
"""

ONE = ["phi3-medium-14b", "deepseek-moe-16b", "falcon-mamba-7b"]


def test_world_of_one_inside_the_mesh_is_bitwise_outside(children):
    """bf16 serve (prefill + 3 decode steps) and one train step of the
    smoke configs, every leaf a DTensor on ``make_host_mesh()``: logits,
    loss, params and optimizer state bitwise the same calls' outside any
    mesh (chip_smoke phase 22 (b)'s check at phi3-medium-14b's full
    size, on the card)."""
    got = _joined(children["one"], "ONE")
    for arch in ONE:
        assert got[arch] == {"serve": True, "loss": True, "params": True,
                             "opt": True, "dtensors": True}, (arch,
                                                              got[arch])
