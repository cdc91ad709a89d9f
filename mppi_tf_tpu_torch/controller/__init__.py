from ..models.dmd import DMDModel
from .dmd import DMDMPPI
from .fleet import FleetMPPI
from .mppi import MPPI, savgol_matrix

__all__ = ["DMDMPPI", "FleetMPPI", "MPPI", "savgol_matrix",
           "get_controller"]

#: env-config keys of the adaptive DMD family and their keywords
_DMD_KEYS = (("refit-every", "refit_every"), ("min-samples", "min_samples"),
             ("buffer-capacity", "buffer_capacity"))


def get_controller(model, cost, config_dict, observer=None, mesh=None,
                   **overrides):
    """Build a single MPPI controller from a parsed env config dict.

    Reference: scripts/src/controller.py:3-38. Keys follow the reference's
    env-config YAML family: samples, horizon, lambda, noise, upsilon,
    init-act, normalize, filter, kernel, antithetic, noise-schedule,
    kernel-dtype. A ``DMDModel`` gets the adaptive ``DMDMPPI`` with
    refit-every, min-samples and buffer-capacity (explicit ``overrides``
    win); other models ignore those keys, as in the JAX package. A
    ``fleet: N`` key builds a ``FleetMPPI`` of N vehicles with the
    per-vehicle ``goals`` key (JAX controller/__init__.py:60-80); a DMD
    model or an observer is refused there with ``ValueError``. Meshes are
    not ported yet and raise ``NotImplementedError`` naming ROADMAP item
    14.
    """
    import numpy as np

    n_fleet = int(overrides.pop("fleet", config_dict.get("fleet", 0)) or 0)
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded controllers are not ported yet: ROADMAP item 14")
    kwargs = dict(
        k=config_dict.get("samples", 1),
        tau=config_dict.get("horizon", 1),
        lam=config_dict.get("lambda", 1.0),
        upsilon=config_dict.get("upsilon", 1.0),
        sigma=np.asarray(config_dict["noise"]),
        normalize_cost=config_dict.get("normalize", False),
        filter_seq=config_dict.get("filter", False),
        kernel=config_dict.get("kernel", "auto"),
        antithetic=config_dict.get("antithetic", False),
        noise_schedule=config_dict.get("noise-schedule"),
        kernel_dtype=config_dict.get("kernel-dtype", "float32"),
    )
    if "init-act" in config_dict:
        ia = np.asarray(config_dict["init-act"], np.float64).reshape(1, -1)
        kwargs["init_seq"] = np.tile(ia, (kwargs["tau"], 1))
    kwargs["log"] = observer is not None
    kwargs.update(overrides)
    if n_fleet:
        if isinstance(model, DMDModel):
            raise ValueError(
                "fleet does not compose with the adaptive DMD family: "
                "build FleetMPPI over an identified DMDModel directly")
        if observer is not None:
            raise ValueError(
                "fleet controllers have no observer surface (log mode is a "
                "single-vehicle debugging tool); drop the observer or the "
                "fleet key")
        kwargs.pop("log")
        kwargs.setdefault("goals", config_dict.get("goals"))
        return FleetMPPI(model, cost, n_vehicles=n_fleet, **kwargs)
    if isinstance(model, DMDModel):
        for key, kw in _DMD_KEYS:
            if key in config_dict:
                kwargs.setdefault(kw, config_dict[key])
        return DMDMPPI(model, cost, observer=observer, **kwargs)
    return MPPI(model, cost, observer=observer, **kwargs)
