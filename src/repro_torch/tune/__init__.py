"""repro_torch.tune — differentiable and Bayesian CC autotuning (port of
``repro.tune``).

``soft`` provides the temperature-smoothed relaxations of the hard gates
in ``core.fluid`` / ``core.cc`` (behind the per-run
``StepParams.temperature``), ``objectives`` the scalar figures of merit
(goodput, p99 flow slowdown, Jain fairness, control-traffic overhead),
``optimizers`` the tuner loops (``GradTuner`` — autograd through the dt
loop of the smoothed model, the CC and ``segment_reduce`` kernels
included; ``ESTuner`` — antithetic evolution strategies; ``BOTuner`` —
GP/Thompson sampling) and ``pareto`` the ``autotune()`` front door plus
scalarisation sweeps producing Pareto fronts.

Lazy exports (PEP 562): ``core.fluid`` imports ``repro_torch.tune.soft``
at module top, so this ``__init__`` must not import the
``repro_torch.core``-heavy submodules eagerly — attribute access
resolves them on demand.
"""

from __future__ import annotations

_EXPORTS = {
    "soft": ("repro_torch.tune.soft", None),
    "objectives": ("repro_torch.tune.objectives", None),
    "optimizers": ("repro_torch.tune.optimizers", None),
    "pareto": ("repro_torch.tune.pareto", None),
    "TunableParam": ("repro_torch.tune.optimizers", "TunableParam"),
    "ParamBox": ("repro_torch.tune.optimizers", "ParamBox"),
    "dcqcn_box": ("repro_torch.tune.optimizers", "dcqcn_box"),
    "rev_box": ("repro_torch.tune.optimizers", "rev_box"),
    "TuneProblem": ("repro_torch.tune.optimizers", "TuneProblem"),
    "Evaluator": ("repro_torch.tune.optimizers", "Evaluator"),
    "box_for": ("repro_torch.tune.optimizers", "box_for"),
    "GradTuner": ("repro_torch.tune.optimizers", "GradTuner"),
    "ESTuner": ("repro_torch.tune.optimizers", "ESTuner"),
    "BOTuner": ("repro_torch.tune.optimizers", "BOTuner"),
    "autotune": ("repro_torch.tune.pareto", "autotune"),
    "pareto_autotune": ("repro_torch.tune.pareto", "pareto_autotune"),
    "pareto_front": ("repro_torch.tune.pareto", "pareto_front"),
    "TuneResult": ("repro_torch.tune.pareto", "TuneResult"),
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.tune' has no attribute {name!r}") from None
    import importlib

    mod = importlib.import_module(mod_name)
    return mod if attr is None else getattr(mod, attr)
