"""The port's perf driver (``repro_torch.launch.perf``) against the
reference's (``repro.launch.perf``), on the CPU.

  * ``_apply_overrides`` gives the reference's config on the same
    ``--set`` strings, a nested ``sec.leaf=`` one included;
  * ``_terms`` divides by one H100's rates, not the TPU's;
  * ``measure`` traces a cell on a fake 256-rank world (a child process)
    and writes its record; ``main`` prints its roofline table against a
    baseline the dry run wrote.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import jax                                                  # noqa: E402

jax.devices()          # jax starts with one device before the import below
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import perf as ref_perf                   # noqa: E402
if _FLAGS is None:     # the reference module writes XLA_FLAGS at import
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from repro.configs import get_config as get_config_R        # noqa: E402
from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.launch import perf                         # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch,sets", [
    ("falcon-mamba-7b", ["ssm_chunk=256", "loss_chunk=512"]),
    ("mixtral-8x22b", ["moe.top_k=1", "moe.capacity_factor=1.5",
                       "moe_impl=onehot"]),
    ("qwen2.5-32b", ["rope_theta=1000000.0", "remat=dots", "n_layers=2"]),
    ("whisper-base", ["encdec.n_enc_layers=2", "vocab=51865"]),
])
def test_apply_overrides_matches_reference(arch, sets):
    got = perf._apply_overrides(get_config(arch), sets)
    want = ref_perf._apply_overrides(get_config_R(arch), sets)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_terms_use_the_h100_rates():
    assert (perf.PEAK_FLOPS, perf.HBM_BW, perf.LINK_BW) == (
        989e12, 3.35e12, 50e9)
    assert not hasattr(perf, "ICI_BW")
    assert (ref_perf.PEAK_FLOPS, ref_perf.HBM_BW) != (perf.PEAK_FLOPS,
                                                      perf.HBM_BW)
    rec = {"flops_total": 989e12, "bytes_accessed_total": 6.7e12,
           "collective_bytes_total": 1e11,
           "memory": {"temp_size_in_bytes": 2 ** 31}}
    assert perf._terms(rec) == {"compute_s": 1.0, "memory_s": 2.0,
                                "collective_s": 2.0, "temp_gib": 2.0}


_CHILD = r"""
import json, sys
from repro_torch.launch import dryrun, perf
out = sys.argv[1]
base = dryrun.run_cell("falcon-mamba-7b", "long_500k", False,
                       out + "/dryrun")
rec = perf.main(["--arch", "falcon-mamba-7b", "--shape", "long_500k",
                 "--tag", "state8", "--set", "ssm.d_state=8",
                 "--dryrun-dir", out + "/dryrun", "--out", out + "/perf"])
print("OUT " + json.dumps({"base": base["path"], "path": rec["path"]}))
"""


def test_measure_writes_its_record(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("OUT ")]
    paths = json.loads(line[-1][4:])
    with open(paths["path"]) as f:
        rec = json.load(f)
    with open(paths["base"]) as f:
        base = json.load(f)
    assert rec["overrides"] == ["ssm.d_state=8"] and rec["tag"] == "state8"
    assert rec["flops_total"] > 0 and base["flops_total"] > 0
    # a smaller SSM state moves fewer bytes than the baseline's 16
    assert rec["memory"]["argument_size_in_bytes"] < \
        base["memory"]["argument_size_in_bytes"]
    for k in ("compute_s", "memory_s", "collective_s", "temp_gib"):
        assert f"  {k}" in out.stdout
    assert "->" in out.stdout
