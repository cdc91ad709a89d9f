"""glue_idle_ms.fleet: the card's idle ms a traced fleet step during which
the host ran the port's own code inside ``FleetMPPI.next``, outside any op
or runtime call: the traced window's idle time labelled
``portbench.next/mppi.*`` (the innermost range open was one of the port's
spans, ``mppi_tf_tpu_torch/tracing.py``), over the traced steps.

A floor: the trace's reading keeps its ten largest idle labels, so a stage
whose idle falls outside them is left out. None without a trace, or where
the port marks no stage (a program without the spans).
"""

#: the idle labels of the port's own stages inside a fleet step
PREFIX = "portbench.next/mppi."


def read(run):
    t = run.trace
    if t is None or not t["units"]:
        return None
    idle = [s for label, s in t["idle_gaps"] if label.startswith(PREFIX)]
    if not idle:
        return None
    return sum(idle) * 1e3 / t["units"]
