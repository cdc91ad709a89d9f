"""replan_p95_ms: the 95th percentile of every ``FleetMPPI.next`` call in
the window, host clock, up to the actions' copy (numpy's linear
interpolation between order statistics)."""

import numpy as np


def read(run):
    d = run.spans.get("next")
    return float(np.percentile(d, 95) * 1e3) if d else None
