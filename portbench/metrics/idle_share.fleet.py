"""idle_share.fleet: the share of the traced fleet steps' window in which
no operation ran on the card, in percent."""


def read(run):
    t = run.trace
    if t is None or "next" not in run.spans or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
