"""The port's fault-tolerant training loop and launcher
(``repro_torch.train.loop``, ``repro_torch.launch.train``) on the CPU,
mirroring the reference's ``tests/test_train_serve.py``: a resumed run is
bitwise the uninterrupted one (losses and every leaf of the state, the
data step and the PRNG key included), a preemption saves, a slow step is
counted as a straggler.  The launcher trains a smoke config and resumes
exactly from its checkpoint directory.  No JAX here: the card test at
the end runs on the GPU machine."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.ckpt import committed_steps, latest_step  # noqa: E402
from repro_torch.data import DataConfig                     # noqa: E402
from repro_torch.models import ModelConfig                  # noqa: E402
from repro_torch.models import transformer as T             # noqa: E402
from repro_torch.models.layers import init_params           # noqa: E402
from repro_torch.optim import AdamWConfig                   # noqa: E402
from repro_torch.optim._tree import leaves                  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, train_loop  # noqa: E402
from repro_torch.train.step import (StepConfig, init_train_state,  # noqa
                                    make_train_step)

CFG = ModelConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
DATA = DataConfig(vocab=256, seq_len=32, global_batch=4, kind="markov")


def _setup(compress=False, microbatches=1):
    params = init_params(T.param_defs(CFG), 0, torch.float32, device="cpu")
    sc = StepConfig(opt=AdamWConfig(lr=3e-3), microbatches=microbatches,
                    compress_grads=compress, warmup_steps=5,
                    total_steps=200)
    return make_train_step(CFG, sc), init_train_state(CFG, params, sc)


def _same_state(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("compress,microbatches", [(False, 1), (True, 2)])
def test_loop_checkpoint_resume_exact(tmp_path, compress, microbatches):
    step, state = _setup(compress, microbatches)
    d = str(tmp_path)
    out1 = train_loop(step, state, DATA,
                      TrainLoopConfig(total_steps=12, ckpt_dir=d,
                                      ckpt_every=6))
    assert committed_steps(d) == [6, 12]
    ref = train_loop(step, state, DATA, TrainLoopConfig(total_steps=18))
    np.testing.assert_array_equal(out1["losses"], ref["losses"][:12])
    out2 = train_loop(step, state, DATA,
                      TrainLoopConfig(total_steps=18, ckpt_dir=d,
                                      ckpt_every=100))
    assert out2["final_step"] == 18
    np.testing.assert_array_equal(out2["losses"], ref["losses"][12:])
    _same_state(out2["state"], ref["state"])
    assert out2["state"].rng.device.type == "cpu"
    assert int(out2["state"].opt.step) == 18


def test_loop_preemption_saves_and_resumes(tmp_path):
    step, state = _setup()
    calls = {"n": 0}

    def stop_flag():
        calls["n"] += 1
        return calls["n"] >= 7

    d = str(tmp_path)
    out = train_loop(step, state, DATA,
                     TrainLoopConfig(total_steps=100, ckpt_dir=d,
                                     ckpt_every=1000),
                     stop_flag=stop_flag)
    assert out["final_step"] == 7 < 100
    assert latest_step(d) == out["final_step"]      # graceful save
    more = train_loop(step, state, DATA,
                      TrainLoopConfig(total_steps=9, ckpt_dir=d,
                                      ckpt_every=1000))
    straight = train_loop(step, state, DATA, TrainLoopConfig(total_steps=9))
    np.testing.assert_array_equal(more["losses"], straight["losses"][7:])
    _same_state(more["state"], straight["state"])


def test_loop_detects_stragglers():
    step, state = _setup()
    slow = {"at": 12}

    def wrapped(s, b):
        import time
        out = step(s, b)
        if slow["at"] == 0:
            time.sleep(0.5)
            slow["at"] = -1
        slow["at"] -= 1
        return out

    out = train_loop(wrapped, state, DATA,
                     TrainLoopConfig(total_steps=20, straggler_factor=3.0))
    assert out["stragglers"] >= 1
    calm = train_loop(step, state, DATA,
                      TrainLoopConfig(total_steps=2, straggler_factor=3.0))
    assert calm["stragglers"] == 0          # no EWMA over warm-up steps


def test_loop_learns():
    step, state = _setup()
    out = train_loop(step, state, DATA, TrainLoopConfig(total_steps=30))
    assert np.all(np.isfinite(out["losses"]))
    assert out["losses"][-5:].mean() < out["losses"][:5].mean() - 0.3


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """A launcher run killed after its step-4 checkpoint (the later one
    removed) and started again resumes there: its step-8 checkpoint is
    bitwise the uninterrupted run's."""
    import shutil
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.launch.train import main
    from repro_torch.train.loop import NT_REGISTRY
    straight, killed = str(tmp_path / "a"), str(tmp_path / "b")
    argv = ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
            "--seq-len", "32", "--log-every", "2", "--ckpt-every", "4",
            "--microbatches", "2", "--compress", "--steps", "8"]
    out = main(argv + ["--ckpt-dir", straight])
    assert committed_steps(straight) == [4, 8]
    shutil.copytree(straight, killed)
    shutil.rmtree(f"{killed}/step_{8:09d}")
    (tmp_path / "b" / f"step_{8:09d}.done").unlink()
    resumed = main(argv + ["--ckpt-dir", killed])
    assert resumed["final_step"] == out["final_step"] == 8
    np.testing.assert_array_equal(resumed["losses"], out["losses"][4:])
    _same_state(resumed["state"], out["state"])
    want, extra = load_checkpoint(straight, 8, nt_registry=NT_REGISTRY)
    got, extra2 = load_checkpoint(killed, 8, nt_registry=NT_REGISTRY)
    assert extra == extra2 == {"data_step": 8}
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert want.rng.dtype == np.uint32 and want.opt.step.dtype == np.int32
    printed = capsys.readouterr().out
    assert "training starcoder2-3b (smoke)" in printed
    assert "final loss" in printed
    with pytest.raises(SystemExit, match="decoder-only"):
        main(["--arch", "whisper-base", "--smoke", "--device", "cpu"])


def test_launcher_needs_a_gpu_or_the_cpu_by_request(monkeypatch):
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "starcoder2-3b", "--smoke", "--steps", "1"])


@pytest.mark.cuda
def test_attention_kernels_refuse_autograd_on_the_card():
    """On the card the kernels raise under autograd instead of dropping
    the gradient; the plain path (``use_pallas=False``) differentiates
    every leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config("starcoder2-3b"),
                              n_layers=2)
    params = init_params(T.param_defs(cfg), 0, device="cuda")
    flat = [p.requires_grad_() for p in leaves(params)]
    toks = torch.randint(0, cfg.vocab, (2, 16), device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        T.loss_fn(params, dataclasses.replace(cfg, use_pallas=True), toks,
                  toks)
    total, _ = T.loss_fn(params, cfg, toks, toks)
    grads = torch.autograd.grad(total, flat)
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
