"""Operations and bytes of the four per-flow CC kernels of
``csrc/cc_step.cu``, a flow each, counted from their plain versions:
float32 inputs read once and outputs written once, and the float32
operations of one update.  Every kernel runs over all R x F flows of the
batch once a step (``cc.dispatch`` evaluates each stage for every run)."""

from ccbench.harness import peaks

#: wrapper -> (device-kernel name fragment, float32 ops a flow, bytes a
#: flow: inputs + outputs, 4 bytes each)
KERNELS = {
    "gen_np_step": ("gen_np_kernel", 9, 4 * (9 + 4)),
    "erp_step": ("erp_kernel", 9, 4 * (5 + 2)),
    "swift_step": ("swift_kernel", 13, 4 * (3 + 2)),
    "rp_step": ("rp_kernel", 24, 4 * (9 + 8)),
}


def ops_bytes(name: str, R: int, F: int) -> tuple[int, int]:
    _, ops, nbytes = KERNELS[name]
    return ops * R * F, nbytes * R * F


def bound_s(name: str, R: int, F: int) -> float:
    """Least seconds of one launch over R x F flows on one H100."""
    ops, nbytes = ops_bytes(name, R, F)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.FP32_FLOPS)


def device_seconds(kernel_s: dict) -> float:
    """Device seconds of the four kernels in a profile ({name: s})."""
    total = 0.0
    for name, s in kernel_s.items():
        if any(frag in name for frag, _, _ in KERNELS.values()):
            total += s
    return total
