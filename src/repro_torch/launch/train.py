"""Train launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch <id> \
        [--smoke] [--steps N] [--ckpt-dir DIR] [--compress] \
        [--microbatches M] [--ckpt-every K] [--device cpu]

The reference's flags, plus ``--device`` (default: the GPU) and
``--ckpt-every`` (default 50, the reference's ``TrainLoopConfig``
default, which its launcher keeps).  As in the
reference, it drives decoder-only LMs (whisper and internvl train
through ``repro_torch.train.step.model_loss``) with float32 params from
seed 0 (``init_params``; the numbers are torch's generator's, not
JAX's), markov data, and the fault-tolerant loop: rerun with the same
``--ckpt-dir`` to resume exactly.  On the card the run takes
deterministic algorithms (``tune.optimizers.deterministic``), so that a
resumed run is bitwise the uninterrupted one there too.  Attention runs
the plain path (the configs' ``use_pallas=False``): the CUDA kernels
have no backward.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..core.fluid import resolve_device
from ..data import DataConfig
from ..models import transformer
from ..models.layers import init_params
from ..optim import AdamWConfig
from ..train.loop import TrainLoopConfig, train_loop
from ..train.step import StepConfig, init_train_state, make_train_step
from ..tune.optimizers import deterministic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    if cfg.encdec is not None or cfg.vlm is not None:
        raise SystemExit(
            "train.py drives decoder-only LMs; whisper/internvl train "
            "through repro_torch.train.step.model_loss.")
    device = resolve_device(args.device)
    print(f"training {cfg.name}{' (smoke)' if args.smoke else ''}: "
          f"{cfg.n_layers}L d{cfg.d_model} "
          f"~{cfg.param_count()/1e6:.1f}M params on {device}")

    params = init_params(transformer.param_defs(cfg), 0, torch.float32,
                         device=device)
    sc = StepConfig(opt=AdamWConfig(lr=args.lr),
                    microbatches=args.microbatches,
                    compress_grads=args.compress,
                    warmup_steps=max(args.steps // 20, 5),
                    total_steps=args.steps)
    state = init_train_state(cfg, params, sc)
    step = make_train_step(cfg, sc)
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch, kind="markov")
    loop = TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           log_every=args.log_every)

    with deterministic(device):
        out = train_loop(step, state, data, loop,
                         on_metrics=lambda s, m: print(
                             f"step {s:5d} loss {float(m['loss']):.4f} "
                             f"({m['step_time']*1e3:.0f} ms)"))
    if len(out["losses"]):
        print(f"final loss {out['losses'][-1]:.4f} after "
              f"{out['final_step']} steps; "
              f"mean step {out['mean_step_time']*1e3:.0f} ms; "
              f"stragglers {out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
