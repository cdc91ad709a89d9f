"""solve_roofline.fleet: the frozen least time of the fleet's solves at
the datasheet peaks (``counts/``, bound named there), over the device time
of every kernel of the traced steps (in a fleet cell the plant is on the
host, so each kernel is the solve's), in percent."""


def read(run):
    t = run.trace
    if t is None or "next" not in run.spans or not t["kernel_s"]:
        return None
    bound_s = run.counts["solve_bound_ms"] * 1e-3 * t["units"]
    return 100.0 * bound_s / t["kernel_s"]
