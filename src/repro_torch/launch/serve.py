"""Serving launcher: batched continuous-batching engine on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch <id> [--smoke]
        [--requests N] [--new-tokens K] [--slots B] [--max-len L]
        [--device cpu]

Port of ``repro.launch.serve`` with the reference's flags.  Params are
random from seed 0 (``init_params``): float32 under ``--smoke``, as in
the reference, and ``cfg.dtype`` (bfloat16) at full size — the one
stated difference from the reference, whose float32 full-size weights
(108.9 GB for gemma2-27b) do not fit one 80 GB card; in bfloat16 they
take 54.45 GB.  Attention runs through the kernels (``use_pallas`` is
set): on the card the CUDA ``flash_attention`` / ``decode_attention``,
on the CPU their plain versions.  Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..core.fluid import resolve_device
from ..models import transformer
from ..models.layers import init_params
from ..serve import ServeConfig, ServingEngine
from ..serve.engine import decoder_only


def param_dtype(cfg, smoke: bool) -> torch.dtype:
    """float32 at smoke size, ``cfg.dtype`` at full size."""
    return torch.float32 if smoke else getattr(torch, cfg.dtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    try:
        decoder_only(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"serve.py: {e}") from None
    cfg = dataclasses.replace(cfg, use_pallas=True)
    device = resolve_device(args.device)
    params = init_params(transformer.param_defs(cfg), 0,
                         param_dtype(cfg, args.smoke), device=device)
    eng = ServingEngine(cfg, params, ServeConfig(
        batch_slots=args.slots, max_len=args.max_len), device=device)
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(2, cfg.vocab, size=5))
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=args.new_tokens)
    dt = time.perf_counter() - t0
    n = sum(len(o) for o in outs)
    print(f"{args.requests} requests -> {n} tokens in {dt:.1f}s "
          f"({n/dt:.1f} tok/s) on {device}")
    return outs


if __name__ == "__main__":
    main()
