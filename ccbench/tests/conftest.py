"""Shared helpers of the benchmark's CPU tests: the checkout's ``src`` and
root on the path, ``run.py`` loaded as a module, and a cell shrunk to a
size the CPU runs in seconds."""

import importlib.util
import os
import sys

import pytest
import torch

# several test workers share the host's cores: a few threads each
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a dragonfly cell cut to 128 flows and 200 steps (flows open at 100 us)
SMALL = {"config": {"horizon_steps": 200},
         "traffic": {"n_flows": 128, "trace_steps": 100,
                     "check": {"runs": 36}}}


@pytest.fixture(scope="session")
def run_mod():
    spec = importlib.util.spec_from_file_location(
        "ccbench_run", os.path.join(ROOT, "ccbench", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
