"""Perf hillclimb driver: re-trace a dry-run cell with optimization
overrides and report the roofline-term deltas vs the recorded baseline
(port of ``repro.launch.perf``).

  python -m repro_torch.launch.perf --arch falcon-mamba-7b \
      --shape train_4k --tag chunk256 --set ssm_chunk=256 \
      --set loss_chunk=512

Writes artifacts/perf/<arch>__<shape>__<tag>.json and prints a
before/after table (baseline read from artifacts/dryrun/pod16x16, as
``python -m repro_torch.launch.dryrun --mesh pod`` writes it).  The
cell is traced on a fake world of 256 ranks (``pod16x16``), started in
``measure``, never at import.  The roofline terms are one H100's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from ..configs import ARCHS, SHAPES, get_config
from .dryrun import _fake_world, _totals, _trace_cell
from .mesh import make_production_mesh

#: dense bf16 tensor-core peak of one H100 SXM5, FLOP/s (NVIDIA H100
#: Tensor Core GPU datasheet: 989.4 TFLOPS without sparsity)
PEAK_FLOPS = 989e12
#: HBM3 bandwidth of one H100 SXM5, B/s (same datasheet: 3.35 TB/s)
HBM_BW = 3.35e12
#: the network rate one GPU of a 256-rank job crosses between nodes: one
#: 400 Gb/s NDR InfiniBand port a GPU, as in a DGX H100 (8 ConnectX-7
#: ports a node) = 50e9 B/s
LINK_BW = 50e9


def _apply_overrides(cfg, sets: list[str]):
    for s in sets:
        key, val = s.split("=", 1)
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        if "." in key:
            sec, leaf = key.split(".", 1)
            cfg = dataclasses.replace(
                cfg, **{sec: dataclasses.replace(
                    getattr(cfg, sec), **{leaf: val})})
        else:
            cfg = dataclasses.replace(cfg, **{key: val})
    return cfg


def _terms(rec):
    return {
        "compute_s": rec["flops_total"] / PEAK_FLOPS,
        "memory_s": rec["bytes_accessed_total"] / HBM_BW,
        "collective_s": rec["collective_bytes_total"] / LINK_BW,
        "temp_gib": rec["memory"].get("temp_size_in_bytes", 0) / 2**30,
    }


def measure(arch: str, shape: str, sets: list[str], tag: str,
            out_dir: str = "artifacts/perf") -> dict:
    cfg = _apply_overrides(get_config(arch), sets)
    _fake_world(256)
    mesh = make_production_mesh(multi_pod=False)
    t0 = time.time()
    full = _trace_cell(cfg, shape, mesh)
    full.update(_totals(full))
    rec = dict(full)
    rec.update({"arch": arch, "shape": shape, "tag": tag,
                "overrides": sets,
                "trace_s": round(time.time() - t0, 1)})
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape}__{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    rec["path"] = path
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--dryrun-dir", default="artifacts/dryrun")
    ap.add_argument("--out", default="artifacts/perf")
    args = ap.parse_args(argv)

    base_path = os.path.join(args.dryrun_dir, "pod16x16",
                             f"{args.arch}__{args.shape}.json")
    base = None
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)

    rec = measure(args.arch, args.shape, args.set, args.tag, args.out)
    new = _terms(rec)
    print(f"\n{args.arch} x {args.shape}  [{args.tag}]  "
          f"overrides={args.set}")
    if base:
        old = _terms(base)
        for k in new:
            delta = (new[k] / old[k] - 1) * 100 if old[k] else float("nan")
            print(f"  {k:14s} {old[k]:12.4g} -> {new[k]:12.4g}  "
                  f"({delta:+.1f}%)")
    else:
        for k, v in new.items():
            print(f"  {k:14s} {v:12.4g}")
    return rec


if __name__ == "__main__":
    main()
