"""nn_roofline.fleet: the least time of the traced fleet steps' NN
rollouts (the ``nn_auv`` counts' ``rollout_floor_s``, a vehicle's, times
the vehicles and the steps) over the device time of the trace's device
operations whose names contain ``nn_fused_solve`` (the NN kernel of every
build, its costs mode included), in percent. None without a trace, or
where no such operation is among the trace's ten largest."""

from portbench.counts import nn_auv


def read(run):
    t = run.trace
    if t is None or not t["units"]:
        return None
    busy = sum(s for name, s in t["device_ops"] if "nn_fused_solve" in name)
    if not busy:
        return None
    floor = (nn_auv.rollout_floor_s(run.config, run.traffic)
             * int(run.traffic["vehicles"]) * t["units"])
    return 100.0 * floor / busy
