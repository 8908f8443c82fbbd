"""Device kernels the profiler records a simulated step in the traced
sweep (the flow tier launches one per PyTorch op inside its captured
windows)."""


def read(rec):
    if rec["timed_by"] != "profiler" or not rec["n_kernels"]:
        return None
    return rec["n_kernels"] / rec["steps"]
