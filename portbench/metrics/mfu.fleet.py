"""mfu.fleet: the frozen operations of every fleet step in the window
(``counts/``), over the window's seconds (host clock), over the f32 peak
outside the tensor cores (67 TFLOP/s, where the solves' arithmetic runs),
in percent."""


def read(run):
    w = run.window
    if "vehicle_solves" not in w or not w["window_s"]:
        return None
    ops = run.counts["solve_ops"] * w["units"]
    return 100.0 * ops / w["window_s"] / run.counts["peaks"]["f32_ops_per_s"]
