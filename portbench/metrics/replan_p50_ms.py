"""replan_p50_ms: the median of every ``FleetMPPI.next`` call in the
window, host clock, up to the actions' copy."""

import numpy as np


def read(run):
    d = run.spans.get("next")
    return float(np.median(d) * 1e3) if d else None
