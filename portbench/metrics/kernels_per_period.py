"""kernels_per_period: kernels the profiler recorded over the traced
runs, a control period (the replayed graph's nodes: the solve's, the
plant's, the pops', the copies')."""


def read(run):
    t = run.trace
    if t is None or "run" not in run.spans or not t["units"]:
        return None
    return t["n_kernels"] / t["units"]
