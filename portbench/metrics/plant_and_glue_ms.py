"""plant_and_glue_ms: device ms a control period of every kernel that is
not the solve's (``solve_kernels/*.json``): the plant's substeps, the
pops, the sequence's update and shift, the copies into the run's
buffers."""


def read(run):
    t = run.trace
    if t is None or "run" not in run.spans or not t["units"]:
        return None
    return (t["kernel_s"] - t["solve_kernel_s"]) / t["units"] * 1e3
