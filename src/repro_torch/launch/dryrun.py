"""Multi-pod dry run: trace every (arch x shape x mesh) cell (port of
``repro.launch.dryrun``).

For each cell this builds the real step function (``make_train_step``
for train_4k, ``prefill`` for prefill_32k, ``decode_step`` for
decode_32k and long_500k), lays its arguments out by the production
shardings, and runs it once on fake DTensors: torch's ``fake`` process
group backend in a world of 256 ranks (``pod16x16``) or 512
(``pod2x16x16``), every local shard a ``FakeTensorMode`` tensor.  No
storage is allocated and no collective moves a byte; what runs is the
program rank 0 would run, op by op, collectives included.

Success == the distribution config is coherent: every sharding divides,
every op has a layout DTensor can run, and the per-rank memory is
reckoned.  Where the reference reads XLA's compiled artifact, the port
counts the trace itself, in one ``TorchDispatchMode`` (``_LocalCounter``)
that sees the ops DTensor runs on each rank's local shards:

  * ``flops`` — ``torch.utils.flop_counter``'s formulas over the LOCAL
    shapes: per rank, as XLA's per-device module counts (a
    ``FlopCounterMode`` over the DTensors would count global shapes);
  * ``bytes_accessed`` — operand plus output bytes of every local op
    but the views.  Unlike XLA's figure, nothing is fused: an
    elementwise chain counts every intermediate;
  * ``collectives`` — the functional collectives DTensor issues
    (``_c10d_functional.*``), output bytes each: ``collective_stats``;
  * ``memory`` — the local storages, tracked as they are made and
    freed: arguments, outputs, the peak live bytes past both
    (``temp_size_in_bytes``) and the donated caches
    (``alias_size_in_bytes``).

Every layer is traced (no ``lax.scan`` body counted once), so the counts
are whole and the ``*_total`` fields are the full trace's; the
reference's 2/4-group probes (``_with_groups``) are kept for shallow
traces, with no extrapolation.

Field names follow the reference's record where the meaning carries.
Changed: ``compile_s`` / ``compile_full_s`` are ``trace_s`` /
``trace_full_s``; ``hlo_bytes`` and ``generated_code_size_in_bytes``
have no counterpart and are left out.  New: ``fits_h100``, one rank's
arguments + outputs + temps - aliased bytes against the 80 GB of an
H100 SXM (recorded, not gated, as the reference records its memory).

Nothing happens at import: the fake world starts inside ``run_cell``;
``--mesh both`` destroys the 256-rank process group and starts a
512-rank one in the same process.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch

from ..configs import ARCHS, SHAPES, get_config, input_specs, supports
from ..dist.sharding import logical_sharding, set_mesh
from ..models import encdec, transformer, vlm
from ..models.config import ModelConfig
from ..models.layers import abstract_params, param_specs
from ..optim import AdamWConfig
from ..train.step import (StepConfig, init_train_state, make_train_step,
                          prng_key, train_state_specs)
from .mesh import describe, make_production_mesh

BF16 = torch.bfloat16

#: HBM of one H100 SXM5: 80 GB of HBM3 (NVIDIA H100 Tensor Core GPU
#: datasheet)
H100_HBM_BYTES = 80e9

#: ``_c10d_functional`` op name prefix -> the reference's HLO kind
COLLECTIVE_KINDS = (("all_reduce", "all-reduce"),
                    ("all_gather", "all-gather"),
                    ("reduce_scatter", "reduce-scatter"),
                    ("all_to_all", "all-to-all"),
                    ("broadcast", "collective-broadcast"))


def collective_stats(events) -> dict:
    """Sum output bytes of every collective: ``events`` are ``(kind,
    dtype, shape)`` triples (the reference parses the same three fields
    from its HLO's lines).  One ``{count, bytes}`` entry a kind, plus
    ``total_bytes``."""
    out: dict[str, dict] = {}
    for kind, dtype, shape in events:
        nbytes = torch.empty((), dtype=dtype).element_size()
        nbytes *= math.prod(shape)
        rec = out.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += nbytes
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    return out


# ---------------------------------------------------------------------------
# the local-op counter
# ---------------------------------------------------------------------------

_VIEWS = {"view", "_unsafe_view", "reshape", "alias", "expand", "permute",
          "transpose", "t", "select", "slice", "unsqueeze", "squeeze",
          "detach", "as_strided", "split", "split_with_sizes", "unbind",
          "chunk", "narrow", "diagonal", "unfold", "view_as_real",
          "view_as_complex", "lift_fresh", "_reshape_alias"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


class _LocalCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ops run on local tensors.  A DTensor-level op returns
    ``NotImplemented`` here, so DTensor runs it and this mode sees the
    local ops (and the collectives) it issues.  DTensor also runs each
    new op once on global-shape fake tensors to learn its output's shape
    (``ShardingPropagator._propagate_tensor_meta_non_cached``): those
    ops are passed through uncounted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.events: list = []
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}
        self._skip = 0
        self._restore = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def propagate(prop, *a, **k):
            counter._skip += 1
            try:
                return orig(prop, *a, **k)
            finally:
                counter._skip -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._restore = (ShardingPropagator, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._restore
        cls._propagate_tensor_meta_non_cached = orig
        return super().__exit__(*exc)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._skip:
            return out
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns == "_c10d_functional":
            for pre, kind in COLLECTIVE_KINDS:
                if name.startswith(pre):
                    for t in _tensors(out):
                        self.events.append((kind, t.dtype, tuple(t.shape)))
                    break
        elif name not in _VIEWS:
            fn = self._flop_registry.get(func._overloadpacket)
            if fn is not None:
                self.flops += int(fn(*args, **kwargs, out_val=out))
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self.track(t)
        return out


# ---------------------------------------------------------------------------
# per-cell step builders (params/caches as fake DTensors)
# ---------------------------------------------------------------------------


def _model_defs(cfg: ModelConfig):
    if cfg.encdec is not None:
        return encdec.param_defs(cfg)
    if cfg.vlm is not None:
        return vlm.param_defs(cfg)
    return transformer.param_defs(cfg)


def _fake_leaf(a: torch.Tensor, dims, mesh):
    """A DTensor of ``a``'s shape and dtype laid out by ``dims``, its
    local shard a fresh tensor of the shard's shape (fake under a
    ``FakeTensorMode``: nothing is allocated)."""
    from torch.distributed.tensor import DTensor
    dims = tuple(dims) if dims is not None else (None,) * a.dim()
    sh = logical_sharding(dims, tuple(a.shape), mesh)
    local = torch.zeros(sh.shard_shape(a.shape), dtype=a.dtype)
    return DTensor.from_local(local, mesh, sh.placements, run_check=False,
                              shape=a.shape, stride=a.stride())


def _sharded_abstract(tree_abs, tree_spec, mesh):
    """The abstract tree (meta tensors) as DTensors laid out by the
    matching dims of ``tree_spec`` (dicts, lists, NamedTuples); a leaf
    that is not a meta tensor (the train state's host key) stays as it
    is."""
    if tree_abs is None:
        return None
    if isinstance(tree_abs, torch.Tensor):
        if not tree_abs.is_meta:
            return tree_abs
        return _fake_leaf(tree_abs, tree_spec, mesh)
    if isinstance(tree_abs, dict):
        return {k: _sharded_abstract(v, tree_spec[k], mesh)
                for k, v in tree_abs.items()}
    out = [_sharded_abstract(a, s, mesh) for a, s in zip(tree_abs, tree_spec)]
    if hasattr(tree_abs, "_fields"):
        return type(tree_abs)(*out)
    return type(tree_abs)(out)


def abstract_cell(cfg: ModelConfig, shape_name: str):
    """(fn, abstract args, their logical dims, donate_argnums) of a cell:
    the args as meta tensors (the train state's key a host tensor) and a
    tree of the same structure holding each leaf's dims.  ``cfg`` is used
    as given (``build_cell`` sets the dry run's dtype and remat)."""
    cell = SHAPES[shape_name]
    defs = _model_defs(cfg)
    p_abs = abstract_params(defs, BF16)
    p_spec = param_specs(defs)
    batch = dict(input_specs(cfg, shape_name))
    b_spec = {k: ("batch",) + (None,) * (v.dim() - 1)
              for k, v in batch.items()}

    if cell.step == "train":
        sc = StepConfig(opt=AdamWConfig(use_master=True))
        with torch._subclasses.fake_tensor.unset_fake_temporarily():
            state = init_train_state(cfg, p_abs, sc)._replace(
                rng=prng_key(0))       # a host tensor, outside any mode
        return (make_train_step(cfg, sc), (state, batch),
                (train_state_specs(cfg, p_spec, sc), b_spec), (0,))

    if cell.step == "prefill":
        if cfg.encdec is not None:
            def fn(p, b):
                return encdec.prefill(p, cfg, b["frames"], b["tokens"],
                                      cell.seq_len)
        elif cfg.vlm is not None:
            def fn(p, b):
                return vlm.prefill(p, cfg, b["patches"], b["tokens"],
                                   cell.seq_len)
        else:
            def fn(p, b):
                return transformer.prefill(p, cfg, b["tokens"], cell.seq_len)
        return fn, (p_abs, batch), (p_spec, b_spec), ()

    # decode: caches as sharded inputs, donated (written in place)
    b = cell.global_batch
    pos = torch.full((), cell.seq_len - 1, dtype=torch.int32)
    if cfg.encdec is not None:
        caches = encdec.init_dec_caches(cfg, b, cell.seq_len, BF16, "meta")
        enc_out = torch.empty((b, cfg.encdec.enc_seq, cfg.d_model),
                              dtype=BF16, device="meta")

        def fn(p, tok, enc, c):
            return encdec.decode_step(p, cfg, tok["token"], enc, c, pos)
        return (fn, (p_abs, batch, enc_out, caches),
                (p_spec, b_spec, ("batch", None, None),
                 encdec.dec_cache_specs(cfg)), (3,))

    caches = transformer.init_caches(cfg, b, cell.seq_len, BF16, "meta")

    def fn(p, tok, c):
        return transformer.decode_step(p, cfg, tok["token"], c, pos)
    return (fn, (p_abs, batch, caches),
            (p_spec, b_spec, transformer.cache_specs(cfg, b, cell.seq_len)),
            (2,))


def _dryrun_config(cfg: ModelConfig) -> ModelConfig:
    """bf16, and remat ``full`` where the config has none (the
    reference's ``build_cell``)."""
    return dataclasses.replace(
        cfg, dtype="bfloat16",
        remat=cfg.remat if cfg.remat != "none" else "full")


def build_cell(cfg: ModelConfig, shape_name: str, mesh):
    """Returns (fn, args: tuple, donate_argnums).  Call it where the
    tensors are to be made: under a ``FakeTensorMode`` they are fake, so
    a full-size cell allocates nothing."""
    with set_mesh(None):     # the abstract trees are plain meta tensors
        fn, args, dims, donate = abstract_cell(_dryrun_config(cfg),
                                               shape_name)
    return fn, _sharded_abstract(args, dims, mesh), donate


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _with_groups(cfg: ModelConfig, k: int) -> ModelConfig:
    """UNROLLED probe config with exactly k pattern groups (the
    reference's: XLA counts a scanned body once, so its dry run
    extrapolates from 2 and 4 groups).  The port traces every layer, so
    its counts are whole; the probes remain for shallow what-ifs."""
    from ..models.transformer import layer_plan
    head, pat, n_groups, tail = layer_plan(cfg)
    if cfg.encdec is not None:   # enc-dec scans n_layers directly
        return dataclasses.replace(cfg, n_layers=k, scan_layers=False,
                                   encdec=dataclasses.replace(
                                       cfg.encdec, n_enc_layers=k))
    new_layers = len(head) + k * len(pat) + len(tail)
    return dataclasses.replace(cfg, n_layers=new_layers,
                               scan_layers=False)


def _storages(tree) -> dict:
    """{storage id: bytes} of the local shards of a tree's tensors."""
    out = {}
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def _trace_cell(cfg, shape_name, mesh, outputs=None) -> dict:
    """Build the cell on fake tensors and run it once under the counter,
    inside ``set_mesh(mesh)`` (the reference's ``_compile_cell``).  A
    list given as ``outputs`` receives the step's (fake) outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    train = SHAPES[shape_name].step == "train"
    with FakeTensorMode(allow_non_fake_inputs=True), set_mesh(mesh):
        fn, args, donate = build_cell(cfg, shape_name, mesh)
        arg_st = _storages(args)
        alias = sum(_storages([args[i] for i in donate]).values())
        counter = _LocalCounter()
        for t in _tensors(args):
            counter.track(_local(t))
        with counter, torch.enable_grad() if train else torch.no_grad():
            out = fn(*args)
        if outputs is not None:
            outputs.append(out)
        out_st = _storages(out)
        new_out = sum(n for k, n in out_st.items() if k not in arg_st)
        arg_bytes = sum(arg_st.values())
        out_bytes = sum(out_st.values())
        temp = max(0, counter.peak - arg_bytes - new_out)
    used = arg_bytes + out_bytes + temp - alias
    return {
        "memory": {"argument_size_in_bytes": int(arg_bytes),
                   "output_size_in_bytes": int(out_bytes),
                   "temp_size_in_bytes": int(temp),
                   "alias_size_in_bytes": int(alias)},
        "flops": float(counter.flops),
        "bytes_accessed": float(counter.bytes_accessed),
        "collectives": collective_stats(counter.events),
        "fits_h100": bool(used <= H100_HBM_BYTES),
    }


def _fake_world(world: int) -> None:
    """Make the default process group a ``fake`` one of ``world`` ranks,
    replacing a fake group of another size (``--mesh both``)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry run needs a fake world of {world} ranks; a "
                f"{dist.get_backend()} group of {dist.get_world_size()} "
                f"is running")
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


def _totals(rec: dict) -> dict:
    return {"flops_total": rec["flops"],
            "bytes_accessed_total": rec["bytes_accessed"],
            "collective_bytes_total": rec["collectives"]["total_bytes"]}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = "artifacts/dryrun") -> dict:
    cfg = get_config(arch)
    ok, why = supports(cfg, shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "skipped": not ok, "skip_reason": why}
    if not ok:
        return rec

    _fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    full = _trace_cell(cfg, shape_name, mesh)
    t_full = time.time() - t0
    from ..models.transformer import layer_plan
    n_groups = (cfg.n_layers if cfg.encdec is not None
                else layer_plan(cfg)[2])
    rec.update(full)
    rec.update(_totals(full))
    rec["scan_groups"] = n_groups
    rec["mesh_desc"] = describe(mesh)
    rec["trace_s"] = round(time.time() - t0, 2)
    rec["trace_full_s"] = round(t_full, 2)
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    path = os.path.join(out_dir, mesh_name, f"{arch}__{shape_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    rec["path"] = path
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    t_all = time.time()
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                mesh_name = "pod2x16x16" if multi else "pod16x16"
                path = os.path.join(args.out, mesh_name,
                                    f"{arch}__{shape}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip-existing] {mesh_name} {arch} {shape}")
                    continue
                tag = f"{mesh_name} {arch:18s} {shape:12s}"
                try:
                    rec = run_cell(arch, shape, multi, args.out)
                except Exception as e:   # noqa: BLE001 — report & continue
                    traceback.print_exc()
                    failures.append((tag, str(e)))
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    continue
                if rec.get("skipped"):
                    print(f"[skip] {tag}: {rec['skip_reason']}", flush=True)
                else:
                    mem = rec["memory"]
                    print(f"[ok]   {tag} trace={rec['trace_s']:.1f}s "
                          f"flops={rec['flops_total']:.3g} "
                          f"coll={rec['collective_bytes_total']:.3g}B "
                          f"temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB"
                          f" fits_h100={rec['fits_h100']}", flush=True)
    print(f"wall {time.time() - t_all:.1f}s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        raise SystemExit(1)
    print("\nDRY-RUN COMPLETE: all attempted cells traced.")


if __name__ == "__main__":
    main()
