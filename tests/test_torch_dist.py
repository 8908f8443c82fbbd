"""The port's process bootstrap (``repro_torch.dist.procs``) and the
fleet's ``DistributedBackend`` over ``torch.distributed``, on the CPU.

  * ``process_info`` is (0, 1) without a process group; ``init_processes``
    joins one (``gloo``, ``tcp://``) and is idempotent;
  * two ``gloo`` processes level one journal-claimed queue through
    ``DistributedBackend``; the coordinator's merged result is bitwise
    equal to the port's one-process ``Sweep.run`` (the reference's
    two-process case, ``tests/test_fleet.py``).
"""

import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist                             # noqa: E402
from repro_torch.dist import init_processes, process_info    # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_process_info_and_idempotent_init():
    assert process_info() == (0, 1)
    port = _free_port()
    try:
        assert init_processes(f"127.0.0.1:{port}", 1, 0) == (0, 1)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert init_processes(f"127.0.0.1:{port + 1}", 5, 3) == (0, 1)
    finally:
        dist.destroy_process_group()
    assert process_info() == (0, 1)


_DIST_CHILD = """
import sys
import torch
torch.set_num_threads(1)
from repro_torch.dist import init_processes, process_info

port, pid, journal = sys.argv[1], int(sys.argv[2]), sys.argv[3]
assert init_processes(f"127.0.0.1:{port}", 2, pid) == (pid, 2)
assert process_info() == (pid, 2)

import repro_torch.core as P
from repro_torch.fleet import (DistributedBackend, FleetConfig,
                               FleetJournal, FleetRunner, plan_sweep)
from _torch_sweeps import RUN, assert_bitwise, grid

sweep = grid(P, RUN)
plan = plan_sweep(sweep, 300, 50, n_shards=3, device="cpu")
jr = FleetJournal(journal)
out = FleetRunner(plan, FleetConfig(claim_timeout_s=60.0, timeout_s=600.0),
                  backend=DistributedBackend(jr), journal=jr).run()
if pid == 0:
    assert out.stats.abandoned == 0, out.outcomes
    assert_bitwise(out.result, sweep.run(300, 50, device="cpu"))
    mine = {o.worker for o in out.outcomes.values()}
    print("DIST_FLEET_BITWISE_OK", sorted(mine))
"""


def test_distributed_fleet_two_processes_bitwise(tmp_path):
    port = _free_port()
    journal = str(tmp_path / "journal")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(os.path.dirname(here), "src"), here,
                    env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_CHILD, str(port), str(pid), journal],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"proc exited {p.returncode}:\n" \
            f"{se[-3000:]}"
    assert "DIST_FLEET_BITWISE_OK" in outs[0][0]
