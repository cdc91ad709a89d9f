"""solve_roofline.loop: the frozen least time of a period's solve at the
datasheet peaks (``counts/``), over the device time of the solve's named
kernels (``solve_kernels/*.json``) a traced period, in percent."""


def read(run):
    t = run.trace
    if t is None or "run" not in run.spans or not t["solve_kernel_s"]:
        return None
    bound_s = run.counts["solve_bound_ms"] * 1e-3 * t["units"]
    return 100.0 * bound_s / t["solve_kernel_s"]
