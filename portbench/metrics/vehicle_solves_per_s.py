"""vehicle_solves_per_s: vehicles times the fleet steps completed in the
window, over the window's seconds (host clock; the host plant's time
between the steps is in the window, as in a fleet's own loop)."""


def read(run):
    w = run.window
    if "vehicle_solves" not in w or not w["window_s"]:
        return None
    return w["vehicle_solves"] / w["window_s"]
