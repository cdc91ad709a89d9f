"""kernels_per_step: kernels the profiler recorded over the traced fleet
steps, a step (``TwoPhaseSolve``'s launches and the host glue's)."""


def read(run):
    t = run.trace
    if t is None or "next" not in run.spans or not t["units"]:
        return None
    return t["n_kernels"] / t["units"]
