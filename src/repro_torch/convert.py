"""Carry state between the reference's arrays and the port's tensors.

The port never sees a JAX array: a caller turns the reference's
NamedTuples into numpy (``jax.tree.map(np.asarray, x)`` or
``jax.device_get``) and hands them here.  Every converter takes the
reference's field names and nesting (``StepParams.mark``/``notif``/
``react`` and ``FluidState.cc`` are dicts) and batched ``[R, ...]``
arrays, as the reference's ``Sweep`` stages them.  ``device=None`` is
the card, as everywhere in the port; pass ``device="cpu"`` for the CPU.

  * ``scenario_from_numpy``   -> ``repro_torch.core.fluid.Scenario``
  * ``scenario_dev_from_numpy`` -> ``ScenarioDev`` (integers as int64)
  * ``step_params_from_numpy`` -> ``StepParams``
  * ``state_from_numpy``      -> ``FluidState``
  * ``state_to_numpy``        -> ``FluidState`` of numpy arrays, with the
    reference's dtypes (float32, and int32 for the integer fields)
"""

from __future__ import annotations

import numpy as np
import torch

from .core.fluid import (FluidState, Scenario, ScenarioDev, StepParams,
                         resolve_device)

_STATE_INT = ("bc_stage", "t_stage", "path_idx", "t")
_PARAM_INT = ("mark_code", "notif_code", "react_code", "route_code")


def _get(x, field):
    return x[field] if isinstance(x, dict) else getattr(x, field)


def _tensor(a, dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                        dtype=dtype)


def _num_dtype(a) -> torch.dtype:
    return torch.int32 if np.issubdtype(np.asarray(a).dtype, np.integer) \
        else torch.float32


def scenario_from_numpy(scn) -> Scenario:
    """The reference's host ``Scenario`` (numpy fields) as the port's."""
    return Scenario(**{f: _get(scn, f) for f in Scenario._fields})


def scenario_dev_from_numpy(sd, device=None) -> ScenarioDev:
    device = resolve_device(device)
    out = {}
    for f in ScenarioDev._fields:
        a = _get(sd, f)
        dt = torch.float32 if np.issubdtype(np.asarray(a).dtype,
                                            np.floating) else torch.int64
        out[f] = _tensor(a, dt, device)
    return ScenarioDev(**out)


def step_params_from_numpy(par, device=None) -> StepParams:
    device = resolve_device(device)
    out = {}
    for f in StepParams._fields:
        a = _get(par, f)
        if f in ("mark", "notif", "react"):
            out[f] = {k: _tensor(v, _num_dtype(v), device)
                      for k, v in a.items()}
        else:
            out[f] = _tensor(a, torch.int32 if f in _PARAM_INT
                             else torch.float32, device)
    return StepParams(**out)


def state_from_numpy(st, device=None) -> FluidState:
    device = resolve_device(device)
    out = {}
    for f in FluidState._fields:
        a = _get(st, f)
        if f == "cc":
            out[f] = {k: _tensor(v, torch.float32, device)
                      for k, v in a.items()}
        else:
            out[f] = _tensor(a, torch.int32 if f in _STATE_INT
                             else torch.float32, device)
    return FluidState(**out)


def _np(x: torch.Tensor, f: str) -> np.ndarray:
    a = x.detach().cpu().numpy()
    return a.astype(np.int32) if f in _STATE_INT else a


def state_to_numpy(st: FluidState) -> FluidState:
    """A port ``FluidState`` as numpy arrays (reference dtypes)."""
    return FluidState(**{
        f: ({k: _np(v, k) for k, v in st.cc.items()} if f == "cc"
            else _np(getattr(st, f), f))
        for f in FluidState._fields})
