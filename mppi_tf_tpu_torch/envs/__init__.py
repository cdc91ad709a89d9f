from .analytic import AUVEnv, PointMassEnv
from .runner import ClosedLoopRunner, build_model_and_cost, run_experiment

__all__ = ["AUVEnv", "PointMassEnv", "ClosedLoopRunner",
           "build_model_and_cost", "get_env", "run_experiment"]


def get_env(env_cfg, render: bool = False, model_cfg=None):
    """Build a simulation environment from an env config dict.

    Reference: scripts/src/mujoco/simulation.py, the env named by the
    config's ``env`` key. ``analytic:point_mass`` (or a missing ``env``
    key) selects the exact point-mass plant; ``analytic:auv`` (or a
    missing ``env`` key with a 13-dim state) the Fossen AUV plant, with the
    vehicle parameters from the env config's ``plant`` sub-dict or
    ``model_cfg``. MuJoCo ``.xml`` scenes (ROADMAP item 15) and the
    on-device ``jax:`` plant (ROADMAP item 13) are not ported yet.
    """
    sdim = env_cfg.get("state-dim", 2)
    adim = env_cfg.get("action-dim", 1)
    name = str(env_cfg.get("env", "analytic:point_mass"))
    if name.endswith(".xml"):
        raise NotImplementedError(
            f"MuJoCo scene {name!r}: the MuJoCo plant is not ported yet: "
            f"ROADMAP item 15")
    if name.startswith("mjx:"):
        raise ValueError(
            "the 'mjx:' plant was removed from the JAX package; use "
            "'analytic:point_mass' (identical semantics for this scene)")
    if name.startswith("jax:"):
        raise NotImplementedError(
            f"plant {name!r}: the on-device closed loop is not ported yet: "
            f"ROADMAP item 13")
    if name == "analytic:auv" or sdim == AUVEnv.STATE_DIM:
        plant_cfg = env_cfg.get("plant") or model_cfg
        if plant_cfg is None:
            raise ValueError(
                "AUV env needs vehicle parameters: pass model_cfg or put a "
                "'plant' sub-dict in the env config")
        ptype = plant_cfg.get("type", "auv")
        if ptype != "auv":
            # a learned-model config must never become the simulator: the
            # experiment would be circular (plant == the model it learns)
            raise ValueError(
                f"the AUV plant needs analytic 'auv' vehicle parameters, "
                f"got a {ptype!r} model config: give the env config a "
                f"'plant' sub-dict with the physical vehicle (e.g. the "
                f"rexrov2 table) when the controller's model is learned")
        return AUVEnv(plant_cfg, render=render)
    return PointMassEnv(n_dof=adim, render=render)
