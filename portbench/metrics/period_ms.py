"""period_ms: the window's seconds over the control periods its runs
completed, runs replayed back to back (host clock; a run's sync and a
mission's re-arm between runs are in the window): the wall time of a
simulated experiment, a period at a time."""


def read(run):
    w = run.window
    if "periods" not in w or not w["periods"]:
        return None
    return w["window_s"] / w["periods"] * 1e3
