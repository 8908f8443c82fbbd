"""The port's ServingEngine against the reference's, on the CPU.

Greedy tokens must be equal, token for token, wherever both sides run in
float32: the gemma2 and starcoder2 smoke configs with the reference's
weights carried across, through the plain attention path and through
``use_pallas``.  The reference's scheduler checks
(``tests/test_train_serve.py``: the wave oracle and refill on EOS) are
repeated on the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import get_smoke_config as smoke_R       # noqa: E402
from repro.models import transformer as T_R                 # noqa: E402
from repro.models.layers import init_params as init_R       # noqa: E402
from repro.serve import ServeConfig as ServeConfig_R        # noqa: E402
from repro.serve import ServingEngine as Engine_R           # noqa: E402
from repro.serve import engine as engine_R                  # noqa: E402
from repro_torch import convert                             # noqa: E402
from repro_torch.configs import get_smoke_config            # noqa: E402
from repro_torch.launch import serve as launch_serve        # noqa: E402
from repro_torch.models import ModelConfig                  # noqa: E402
from repro_torch.models.attention import KVCache            # noqa: E402
from repro_torch.models import transformer as T_P           # noqa: E402
from repro_torch.models.layers import init_params           # noqa: E402
from repro_torch.serve import ServeConfig, ServingEngine    # noqa: E402
from repro_torch.serve import engine as engine_P            # noqa: E402

#: the reference's tiny serving config (tests/test_train_serve.py)
CFG = ModelConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)


def _engine(cfg, sv, params=None):
    if params is None:
        params = init_params(T_P.param_defs(cfg), 0, device="cpu")
    return ServingEngine(cfg, params, sv, device="cpu")


@pytest.mark.parametrize("arch,use_pallas", [
    ("gemma2-27b", False), ("gemma2-27b", True), ("starcoder2-3b", True)])
def test_generate_matches_reference(arch, use_pallas):
    """6 ragged prompts on 3 slots, EOS live: refills and a second joint
    prefill, prompts longer than gemma2's window of 16."""
    cfg_r = dataclasses.replace(smoke_R(arch), use_pallas=use_pallas)
    cfg_p = dataclasses.replace(get_smoke_config(arch), use_pallas=use_pallas)
    params_r = init_R(T_R.param_defs(cfg_r), 0, jnp.float32)
    params_p = convert.params_from_numpy(
        cfg_p, jax.tree.map(np.asarray, params_r), device="cpu")
    rng = np.random.RandomState(3)
    prompts = [[int(x) for x in rng.randint(2, cfg_r.vocab, 6 + 3 * i)]
               for i in range(6)]
    # EOS = request 0's 3rd greedy token, so slots free mid-flight
    probe = _engine(cfg_p, ServeConfig(batch_slots=3, max_len=64,
                                       eos_token=-1), params_p)
    eos = probe.generate(prompts, max_new_tokens=3)[0][2]
    sv = dict(batch_slots=3, max_len=64, eos_token=eos)
    want_eng = Engine_R(cfg_r, params_r, ServeConfig_R(**sv))
    want = want_eng.generate(prompts, max_new_tokens=8)
    eng = _engine(cfg_p, ServeConfig(**sv), params_p)
    got = eng.generate(prompts, max_new_tokens=8)
    assert got == want
    assert eng.stats == want_eng.stats
    assert eng.stats["refills"] >= 1, eng.stats


def test_serving_engine_continuous_batching():
    eng = _engine(CFG, ServeConfig(batch_slots=2, max_len=64))
    prompts = [[3, 4, 5], [7, 8, 9], [11, 12, 13]]   # > slots: 2 waves
    outs = eng.generate(prompts, max_new_tokens=6)
    assert len(outs) == 3
    assert all(1 <= len(o) <= 6 for o in outs)
    # greedy determinism: same prompt -> same continuation
    assert eng.generate([prompts[0]], max_new_tokens=6)[0] == outs[0]


def test_serving_engine_matches_wave_oracle():
    """With EOS disabled the refill scheduler degenerates to waves:
    outputs must equal the wave implementation exactly."""
    eng = _engine(CFG, ServeConfig(batch_slots=3, max_len=64, eos_token=-1))
    rng = np.random.RandomState(0)
    prompts = [[int(x) for x in rng.randint(2, 255, 2 + i % 4)]
               for i in range(7)]
    got = eng.generate(prompts, max_new_tokens=6)
    assert eng.stats["refills"] == 0          # EOS never fires
    assert got == eng._generate_waves(prompts, max_new_tokens=6)


def test_serving_engine_refills_on_eos():
    """A finished slot is refilled mid-flight, and the refilled
    request's output equals serving it alone with the same left
    padding (rows are independent under the causal position mask)."""
    params = init_params(T_P.param_defs(CFG), 0, device="cpu")
    probe = _engine(CFG, ServeConfig(batch_slots=2, max_len=64,
                                     eos_token=-1), params)
    p0, p1, p2 = [3, 4, 5], [7, 8, 9], [11, 12, 13]
    free = probe.generate([p0, p1], max_new_tokens=8)
    eos = free[0][2]                    # row 0's 3rd token becomes EOS
    # precondition: slot 0 must free first, else p2 rides slot 1
    assert eos not in free[1][:free[0].index(eos) + 1]

    eng = _engine(CFG, ServeConfig(batch_slots=2, max_len=64,
                                   eos_token=eos), params)
    outs = eng.generate([p0, p1, p2], max_new_tokens=8)
    assert eng.stats["refills"] >= 1
    assert eng.stats["prefills"] == 1   # p2 rode slot 0, no new wave
    assert outs[0][-1] == eos           # request 0 stopped at EOS
    pos = len(p0) + outs[0].index(eos)
    padded = [0] * (pos - len(p2)) + p2
    solo = eng.generate([padded], max_new_tokens=8)
    assert outs[2] == solo[0][:len(outs[2])]


@pytest.mark.parametrize("arch", ["gemma2-27b", "recurrentgemma-9b",
                                  "falcon-mamba-7b", "deepseek-moe-16b",
                                  "mixtral-8x22b"])
def test_launcher_runs_on_cpu_by_request(capsys, arch):
    outs = launch_serve.main(["--arch", arch, "--smoke",
                              "--requests", "3", "--new-tokens", "4",
                              "--device", "cpu"])
    assert len(outs) == 3 and all(1 <= len(o) <= 4 for o in outs)
    assert "on cpu" in capsys.readouterr().out
    cfg = get_smoke_config("gemma2-27b")
    assert launch_serve.param_dtype(cfg, True) == torch.float32
    assert launch_serve.param_dtype(
        dataclasses.replace(cfg), False) == torch.bfloat16


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "falcon-mamba-7b"])
def test_engine_state_stays_in_its_storage(arch):
    """What a captured decode step needs: the engine's caches keep their
    storage through decode steps, refills and a second joint prefill,
    and a decode step writes each recurrent layer's new state into it
    (the reference's engine gets new arrays back instead)."""
    cfg = get_smoke_config(arch)
    params = init_params(T_P.param_defs(cfg), 0, device="cpu")
    eng = _engine(cfg, ServeConfig(batch_slots=2, max_len=64), params)
    rng = np.random.RandomState(9)
    prompts = [[int(x) for x in rng.randint(2, cfg.vocab, 5 + i)]
               for i in range(5)]
    eng.generate(prompts[:2], max_new_tokens=3)
    ptrs = [[x.data_ptr() for x in c] for c in eng._caches]
    states = [c for c in eng._caches if not isinstance(c, KVCache)]
    assert states
    before = [[x.clone() for x in c] for c in states]
    eng._step(np.asarray([3, 4], np.int32))
    assert all(not torch.equal(a, b) for c, old in zip(states, before)
               for a, b in zip(c, old))
    eng.generate(prompts, max_new_tokens=4)
    assert [[x.data_ptr() for x in c] for c in eng._caches] == ptrs


def test_engine_refuses_params_on_another_device():
    params = init_params(T_P.param_defs(CFG), 0, device="cpu")
    with pytest.raises(ValueError, match="params on"):
        ServingEngine(CFG, params, ServeConfig(), device="meta")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_step_builders_match_reference(use_pallas):
    """``make_prefill`` / ``make_serve_step`` (what the engine runs)
    against the reference's, jitted as its engine jits them: a prefill,
    then 10 greedy steps past gemma2's window of 16 with ``pos`` a device
    tensor; a second prefill rewriting the used caches in place equals a
    prefill into fresh ones, bit for bit."""
    arch = "gemma2-27b"
    cfg_r = dataclasses.replace(smoke_R(arch), use_pallas=use_pallas)
    cfg_p = dataclasses.replace(get_smoke_config(arch), use_pallas=use_pallas)
    params_r = init_R(T_R.param_defs(cfg_r), 0, jnp.float32)
    params_p = convert.params_from_numpy(
        cfg_p, jax.tree.map(np.asarray, params_r), device="cpu")
    max_len = 40
    prefill_r = jax.jit(engine_R.make_prefill(cfg_r, max_len))
    step_r = jax.jit(engine_R.make_serve_step(cfg_r))
    prefill_p = engine_P.make_prefill(cfg_p, max_len)
    step_p = engine_P.make_serve_step(cfg_p)
    toks = np.random.RandomState(7).randint(2, cfg_r.vocab, (3, 12)) \
        .astype(np.int32)
    lr, cr = prefill_r(params_r, jnp.asarray(toks))
    lp, cp = prefill_p(params_p, torch.from_numpy(toks))
    got, want = [lp[:, -1].argmax(-1)], [np.asarray(lr)[:, -1].argmax(-1)]
    pos = torch.tensor(12, dtype=torch.int32)
    for p in range(12, 22):
        cur = want[-1].astype(np.int32)
        lr, cr = step_r(params_r, jnp.asarray(cur[:, None]), cr,
                        jnp.asarray(p, jnp.int32))
        lp, cp = step_p(params_p, torch.from_numpy(cur[:, None]), cp, pos)
        pos = cp[0].pos
        want.append(np.asarray(lr)[:, 0].argmax(-1))
        got.append(lp[:, 0].argmax(-1))
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert int(pos) == 22
    other = np.random.RandomState(8).randint(2, cfg_r.vocab, (3, 20)) \
        .astype(np.int32)
    l_into, c_into = prefill_p(params_p, torch.from_numpy(other), cp)
    l_new, c_new = prefill_p(params_p, torch.from_numpy(other))
    assert torch.equal(l_into, l_new)
    for a, b, used in zip(c_into, c_new, cp):
        assert a.k is used.k and torch.equal(a.k, b.k)
        assert torch.equal(a.v, b.v) and torch.equal(a.pos, b.pos)
