"""Operations and bytes of one ``megastep_block`` launch of
``csrc/fluid_step.cu``: a whole trace window of the batch.  Bytes: the
state read and written once, the scenario read once, the window's trace
written once.  Operations: 48 float32 operations a (flow, hop) a step
(generation, transfers, EWMA, PFC inputs, surplus, grants, marking) and 8
an incidence entry walked (the 3 + 3 + 2 channel adds of the link sums),
as counted from the kernel's source."""

from ccbench.harness import peaks

OPS_PER_FLOW_HOP = 48
OPS_PER_ENTRY = 8


def ops_bytes(shapes: dict, n_steps: int) -> tuple[int, int]:
    R, F, H = shapes["R"], shapes["F"], shapes["H"]
    trace = 4 * R * F * 3 + 4 * R * F + 16 * R
    nbytes = 2 * shapes["state_bytes"] + shapes["scenario_bytes"] + trace
    ops = n_steps * (OPS_PER_FLOW_HOP * R * F * H
                     + OPS_PER_ENTRY * shapes["entries"])
    return ops, nbytes


def bound_s(shapes: dict, n_steps: int) -> float:
    """Least seconds of one launch of ``n_steps`` steps on one H100."""
    ops, nbytes = ops_bytes(shapes, n_steps)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.FP32_FLOPS)
