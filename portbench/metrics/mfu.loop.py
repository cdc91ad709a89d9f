"""mfu.loop: the frozen operations of every control period in the window,
the solve's and the plant's (``counts/``), over the window's seconds
(host clock), over the f32 peak outside the tensor cores (67 TFLOP/s), in
percent."""


def read(run):
    w = run.window
    if "periods" not in w or not w["window_s"]:
        return None
    ops = (run.counts["solve_ops"] + run.counts["plant_ops"]) * w["periods"]
    return 100.0 * ops / w["window_s"] / run.counts["peaks"]["f32_ops_per_s"]
