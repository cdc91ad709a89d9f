from ..models.dmd import DMDModel
from .dmd import DMDMPPI, ShardedDMDMPPI, ShardedFusedDMDMPPI
from .fleet import FleetMPPI
from .mppi import MPPI, savgol_matrix

__all__ = ["DMDMPPI", "FleetMPPI", "MPPI", "ShardedDMDMPPI",
           "ShardedFusedDMDMPPI", "savgol_matrix", "get_controller"]

#: env-config keys of the adaptive DMD family and their keywords
_DMD_KEYS = (("refit-every", "refit_every"), ("min-samples", "min_samples"),
             ("buffer-capacity", "buffer_capacity"))

#: the options the fused sharded path takes (JAX
#: controller/__init__.py:121-124)
_FUSED_OPTS = ("normalize_cost", "clip_actions", "filter_seq",
               "filter_window", "filter_polyorder", "antithetic",
               "noise_schedule", "kernel_dtype")


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
    model or an observer is refused there with ``ValueError``.

    A ``mesh`` (``parallel.mesh.Mesh``) returns the mesh-sharded
    controller (JAX :82-158): ``ShardedFusedMPPI`` when ``kernel`` is
    ``"cuda"``, or ``"auto"`` on a mesh of CUDA shards, and a fused solve
    supports the pair, else the torch-route ``ShardedMPPI`` (their
    adaptive DMD classes for a ``DMDModel``); with ``fleet``, the mesh
    shards the vehicles (``FleetMPPI(mesh=)``).
    """
    import numpy as np

    n_fleet = int(overrides.pop("fleet", config_dict.get("fleet", 0)) or 0)
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
        return FleetMPPI(model, cost, n_vehicles=n_fleet, mesh=mesh,
                         **kwargs)
    if isinstance(model, DMDModel):
        for key, kw in _DMD_KEYS:
            if key in config_dict:
                kwargs.setdefault(kw, config_dict[key])
    if mesh is not None:
        return _mesh_controller(model, cost, observer, mesh, kwargs)
    if isinstance(model, DMDModel):
        return DMDMPPI(model, cost, observer=observer, **kwargs)
    return MPPI(model, cost, observer=observer, **kwargs)


def _mesh_controller(model, cost, observer, mesh, kwargs: dict):
    """The mesh branch of ``get_controller``: the fused class where the
    kernel is asked for (or ``"auto"`` on CUDA shards) and fits, else the
    torch-route class, with the JAX package's refusals: ``TypeError`` for
    an explicit kernel on a non-f32 model or an unknown option of the
    fused path, ``ValueError`` for a kernel-dtype on the torch route."""
    import torch

    from ..kernels.errors import KernelUnsupportedError
    from ..parallel.fused import ShardedFusedMPPI
    from ..parallel.sharded import ShardedMPPI
    from .mppi import _KERNEL_ALIASES

    is_dmd = isinstance(model, DMDModel)
    fused_cls, torch_cls = ((ShardedFusedDMDMPPI, ShardedDMDMPPI) if is_dmd
                            else (ShardedFusedMPPI, ShardedMPPI))
    kernel = kwargs.pop("kernel", "auto")
    kernel = _KERNEL_ALIASES.get(kernel, kernel)
    if kernel not in ("torch", "cuda", "auto"):
        raise ValueError(f"unknown kernel {kernel!r}")
    kwargs.pop("log", None)   # the sharded info is the reduced set
    base = dict(k=kwargs.pop("k"), tau=kwargs.pop("tau"),
                lam=kwargs.pop("lam"), upsilon=kwargs.pop("upsilon"),
                sigma=kwargs.pop("sigma"), observer=observer,
                init_seq=kwargs.pop("init_seq", None),
                seed=kwargs.pop("seed", 0))
    blockers = ([] if model.dtype == torch.float32 else
                [f"dtype={model.dtype} (kernel is f32)"])
    on_card = mesh.device.type == "cuda"
    if kernel == "cuda" or (kernel == "auto" and not blockers and on_card):
        if kernel == "cuda" and blockers:
            raise TypeError(f"kernel='cuda' (the JAX package's 'pallas') "
                            f"does not support {blockers}")
        opts = _FUSED_OPTS + (tuple(kw for _, kw in _DMD_KEYS) if is_dmd
                              else ())
        leftovers = sorted(set(kwargs) - set(opts))
        if leftovers:
            raise TypeError(f"unknown controller option(s) {leftovers} for "
                            "the fused sharded path")
        try:
            return fused_cls(model, cost, mesh, **base,
                             **{o: kwargs[o] for o in opts if o in kwargs})
        except KernelUnsupportedError:
            if kernel == "cuda":
                raise
    if kwargs.pop("kernel_dtype", "float32") != "float32":
        raise ValueError(
            "kernel-dtype applies to the fused kernel path only; this "
            "controller resolved to the torch-route sharded solve")
    return torch_cls(model, cost, mesh, **base, **kwargs)
