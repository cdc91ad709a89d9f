"""The bf16 block compute of the point-mass kernels (compute_dtype=
"bfloat16"): the port's plain bf16 versions against the JAX package's
Pallas kernels at compute_dtype="bfloat16" (interpret mode, injected
normals), the bf16 noise, and the controller's kernel_dtype option.

The criterion (``passes``): over per-sample costs, mean |port bf16 - JAX
bf16| is at most RATIO_MAX times mean |JAX bf16 - JAX f32| (the bf16
gap), and the port's own bf16 - f32 difference correlates with JAX's at
CORR_MIN or more. Every test also holds the port's f32 version to the
same criterion and asserts that it fails: the criterion tells bf16 from
f32.

By default XLA may keep bf16 intermediates at a higher precision, so
interpret mode skips roundings that the kernel's bf16 arrays imply (at
tests/test_bf16_kernel.py's shapes the point mass then lands at ratio
0.06-0.35 and the AUV at 2.3 from the port's per-op rounding). The
references here are compiled without that (``exact_jax``): they round
where the JAX kernel's code says, and the port's plain bf16 costs equal
them bit for bit, which the tests also assert.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller import get_controller as jget_controller
from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.kernels.pm_mppi import FusedLTIMPPI as JLTI
from mppi_tf_tpu.kernels.pm_mppi import FusedPointMassMPPI as JFused
from mppi_tf_tpu.kernels.pm_mppi import chunk_noise
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu.models.dmd import DMDModel as JDMDModel
from mppi_tf_tpu_torch.controller import MPPI, get_controller
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.models.dmd import DMDModel

SIGMA = np.diag([0.25, 0.3, 0.2])
LAM, GAMMA, UPS = 0.8, 0.2, 1.2
TASK = {"type": "static", "diag": True,
        "goal": [1.0, 0.0, 0.5, 0.0, -0.5, 0.0],
        "Q": [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]}
MODEL = {"type": "point_mass", "mass": 1.3}
ELIPSE = {"type": "elipse", "a": 2.0, "b": 1.5, "center_x": 0.25,
          "center_y": -0.25, "speed": 1.25, "m_state": 4.0, "m_vel": 0.5}
# three legs of the 3-DoF point mass (the waypoint blend of the kernels'
# effective goal, tests/test_torch_tracking_kernels.py)
WAYPOINTS = {"type": "waypoints", "diag": True, "alpha": 0.2,
             "Q": [6.0, 0.6, 6.0, 0.6, 6.0, 0.6],
             "waypoints": [[0.8, 0, 0, 0, 0, 0], [0.8, 0, -0.7, 0, 0, 0],
                           [0.0, 0, -0.7, 0, 0.4, 0]]}
# tests/test_bf16_kernel.py's family: K=160, H=3 at tile 32
K, TAU, TILE = 160, 3, 32
# the criterion's limits (the costs below measure 0 and 1: bit parity)
RATIO_MAX, CORR_MIN = 0.35, 0.9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


#: XLA may keep a bf16 intermediate at a higher precision by default
#: (DebugOptions.xla_allow_excess_precision): interpret mode then skips
#: roundings the Pallas kernel's bf16 arrays imply. The references here
#: compile without it, so they round where the JAX kernel's code says.
EXACT = {"xla_allow_excess_precision": False}
_COMPILED = {}


def exact_jit(jitted):
    """``jitted`` (a JAX kernel entry point with static keywords) compiled
    with ``EXACT``, once per static keywords and argument shapes."""
    def call(*args, **static):
        key = (jitted, tuple(sorted(static.items())),
               tuple(None if a is None else (jnp.shape(a), jnp.result_type(a))
                     for a in args))
        if key not in _COMPILED:
            _COMPILED[key] = jitted.lower(*args, **static).compile(
                compiler_options=EXACT)
        return _COMPILED[key](*args)
    return call


@pytest.fixture
def exact_jax(monkeypatch):
    """The JAX package's Pallas entry points compiled with ``EXACT``."""
    from mppi_tf_tpu.kernels import auv_mppi as jauv
    from mppi_tf_tpu.kernels import nn_mppi as jnn
    from mppi_tf_tpu.kernels import pm_mppi as jpm

    for mod, names in ((jpm, ("fused_pm_call", "fused_pm_costs",
                              "fused_pm_weights")),
                       (jauv, ("_fused_auv_call", "_fused_auv_costs",
                               "_fused_auv_weights")),
                       (jnn, ("_fused_nn_call", "_fused_nn_costs",
                              "_fused_nn_weights"))):
        for name in names:
            monkeypatch.setattr(mod, name, exact_jit(getattr(mod, name)))


def criterion(port16, port32, jax16, jax32):
    """(mean |port16 - jax16| / mean |jax16 - jax32|, the correlation of
    port16 - port32 with jax16 - jax32), over flattened arrays."""
    port16, port32, jax16, jax32 = (np.asarray(a, np.float64).ravel()
                                    for a in (port16, port32, jax16, jax32))
    gap = np.abs(jax16 - jax32).mean()
    ratio = np.abs(port16 - jax16).mean() / gap
    a, b = port16 - port32, jax16 - jax32
    corr = (float(np.dot(a - a.mean(), b - b.mean())
                  / (np.linalg.norm(a - a.mean()) * np.linalg.norm(b - b.mean())))
            if np.any(a != a.mean()) else 0.0)
    return ratio, corr


def passes(port16, port32, jax16, jax32, ratio_max=RATIO_MAX,
           corr_min=CORR_MIN) -> bool:
    ratio, corr = criterion(port16, port32, jax16, jax32)
    return ratio <= ratio_max and corr >= corr_min


def assert_bf16_side(port16, port32, jax16, jax32, ratio_max=RATIO_MAX,
                     corr_min=CORR_MIN):
    """The port's bf16 values pass the criterion and its f32 values, in
    the bf16 slot, fail it."""
    ratio, corr = criterion(port16, port32, jax16, jax32)
    assert ratio <= ratio_max and corr >= corr_min, (ratio, corr)
    assert not passes(port32, port32, jax16, jax32, ratio_max, corr_min), \
        criterion(port32, port32, jax16, jax32)


def _inputs(k, tau, adim=3, seed=3, x0=(0.2, 0.0, -0.1, 0.0, 0.3, 0.0)):
    rng = np.random.RandomState(seed)
    z = rng.randn(tau, adim, k).astype(np.float32)
    useq = (0.1 * rng.randn(tau, adim)).astype(np.float32)
    return z, np.asarray(x0, np.float64), useq


def _jax(cd, k=K, tau=TAU, task=TASK, sdim=6, adim=3, **kw):
    model = jget_model(MODEL, dt=0.1, state_dim=sdim, action_dim=adim)
    cost = jget_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPS,
                     sigma=SIGMA[:adim, :adim])
    fused = JFused(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                   sigma=SIGMA[:adim, :adim], tile=TILE, interpret=True,
                   compute_dtype=cd, **kw)
    return fused, model.init_params(), cost.init_params()


def _port(cd, k=K, tau=TAU, task=TASK, sdim=6, adim=3, **kw):
    model = get_model(MODEL, dt=0.1, state_dim=sdim, action_dim=adim,
                      device="cpu")
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPS,
                    sigma=SIGMA[:adim, :adim], device="cpu")
    return pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                 upsilon=UPS, sigma=SIGMA[:adim, :adim],
                                 compute_dtype=cd, **kw)


def _costs_both(make_jax, make_port, z, x0, useq, tile=TILE):
    """Per-sample phase-A costs {(side, dtype): [k]} on injected z."""
    k = z.shape[-1]
    out = {}
    for cd in ("float32", "bfloat16"):
        jf, mp, cp = make_jax(cd)
        c, _ = jf.costs_phase(0, x0, useq, mp, cp,
                              z=jnp.asarray(chunk_noise(z, tile)),
                              use_prng=False)
        out["jax", cd] = np.asarray(c).reshape(-1)[:k]
        c, _ = make_port(cd).costs_phase(torch.as_tensor(x0),
                                         torch.as_tensor(useq),
                                         z=torch.as_tensor(z))
        out["port", cd] = c.numpy()
    return out


def _assert_costs(out):
    assert_bf16_side(out["port", "bfloat16"], out["port", "float32"],
                     out["jax", "bfloat16"], out["jax", "float32"])
    np.testing.assert_array_equal(out["port", "bfloat16"],
                                  out["jax", "bfloat16"])


def _static_task(sdim):
    """TASK at (6, 3); a static cost of its kind at the smaller dims."""
    return TASK if sdim == 6 else {"type": "static", "diag": True,
                                   "goal": [0.5, 0.0, -0.25, 0.0][:sdim],
                                   "Q": [5.0, 1.0, 3.0, 0.5][:sdim]}


@pytest.mark.parametrize("k,tau,sdim,adim", [
    pytest.param(K, TAU, 6, 3, id="160-3"),
    pytest.param(256, 10, 6, 3, id="256-10"),
    pytest.param(K, TAU, 2, 1, id="2x1"),
    pytest.param(K, TAU, 4, 2, id="4x2")])
def test_plain_bf16_costs_match_pallas_bf16(exact_jax, k, tau, sdim, adim):
    """The static cost at (6, 3), at the JAX bf16 test's shapes and at
    K=256, H=10, and at the kernels' other quadratic dims (2, 1) and
    (4, 2); the f32 plain version fails the criterion."""
    task = _static_task(sdim)
    z, x0, useq = _inputs(k, tau, adim,
                          x0=(0.2, 0.0, -0.1, 0.0, 0.3, 0.0)[:sdim])
    out = _costs_both(lambda cd: _jax(cd, k, tau, task, sdim, adim),
                      lambda cd: _port(cd, k, tau, task, sdim, adim), z, x0,
                      useq)
    _assert_costs(out)
    # the f32 versions agree as before: rounding only
    np.testing.assert_allclose(out["port", "float32"], out["jax", "float32"],
                               rtol=1e-5)


def test_plain_bf16_solve_stats_and_wnoise(exact_jax):
    """The fused solve at bf16 against JAX's at the JAX bf16 test's
    tolerances (tests/test_bf16_kernel.py:54-63), and against the port's
    f32 solve likewise."""
    z, x0, useq = _inputs(K, TAU)
    jf, mp, cp = _jax("bfloat16")
    wn_j, st_j = jf.solve(0, x0, useq, mp, cp,
                          z=jnp.asarray(chunk_noise(z, TILE)),
                          use_prng=False)
    args = (torch.as_tensor(x0), torch.as_tensor(useq))
    wn16, st16 = _port("bfloat16").solve(*args, z=torch.as_tensor(z))
    wn32, st32 = _port("float32").solve(*args, z=torch.as_tensor(z))
    for ref_wn, ref_st in ((np.asarray(wn_j), st_j), (wn32.numpy(), st32)):
        np.testing.assert_allclose(wn16.numpy(), ref_wn, rtol=0.2,
                                   atol=0.05 * np.abs(ref_wn).max())
        for key in ("cost_min", "cost_max", "cost_mean"):
            np.testing.assert_allclose(float(st16[key]), float(ref_st[key]),
                                       rtol=0.03)
    assert np.isfinite(float(st16["nabla"]))
    # the bf16 solve's weighted noise is the closer to JAX's bf16 one
    assert (np.abs(wn16.numpy() - np.asarray(wn_j)).mean()
            < np.abs(wn32.numpy() - np.asarray(wn_j)).mean())


def test_plain_bf16_scheduled_normalized(exact_jax):
    """bf16 with a noise schedule through the two-phase normalized solve
    (tests/test_bf16_kernel.py:140-171): the per-sample costs under the
    criterion, the stats at rtol 0.03, the solution's direction."""
    k, c = 128, np.linspace(1.0, 0.4, TAU)
    z, x0, useq = _inputs(k, TAU, seed=5)
    out = _costs_both(lambda cd: _jax(cd, k, schedule=c),
                      lambda cd: _port(cd, k, schedule=c), z, x0, useq)
    _assert_costs(out)
    jf, mp, cp = _jax("bfloat16", k, schedule=c)
    wn_j, st_j = jf.solve(0, x0, useq, mp, cp,
                          z=jnp.asarray(chunk_noise(z, TILE)),
                          use_prng=False, normalize=True)
    wn, st = _port("bfloat16", k, schedule=c).solve(
        torch.as_tensor(x0), torch.as_tensor(useq), z=torch.as_tensor(z),
        normalize=True)
    for key in ("cost_min", "cost_max", "cost_mean"):
        np.testing.assert_allclose(float(st[key]), float(st_j[key]),
                                   rtol=0.03)
    a, b = wn.numpy().ravel(), np.asarray(wn_j).ravel()
    assert np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.7


def _lti_pair(k, tau, seed, **kw):
    """(make_jax, make_port) of FusedLTIMPPI over a dense random (A, B)."""
    rng = np.random.RandomState(seed)
    A = np.eye(6) + 0.05 * rng.randn(6, 6)
    B = 0.1 * rng.randn(6, 3)

    def make_jax(cd):
        model = JDMDModel(6, 3, init_A=A, init_B=B, dtype=jnp.float32)
        cost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS,
                         sigma=SIGMA)
        return (JLTI(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                     sigma=SIGMA, tile=TILE, interpret=True,
                     compute_dtype=cd, **kw),
                model.init_params(), cost.init_params())

    def make_port(cd):
        cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
        return pm.FusedLTIMPPI(DMDModel(6, 3, init_A=A, init_B=B), cost,
                               k=k, tau=tau, lam=LAM, upsilon=UPS,
                               sigma=SIGMA, compute_dtype=cd, **kw)

    return make_jax, make_port


def test_plain_bf16_dynamic_ab_matches_pallas_bf16(exact_jax):
    """The dense smem_dot rollout of FusedLTIMPPI at bf16 over a dense
    random (A, B) (tests/test_pallas_kernel.py:386-408)."""
    z, x0, useq = _inputs(K, TAU, seed=11)
    _assert_costs(_costs_both(*_lti_pair(K, TAU, 5), z, x0, useq))


def test_plain_bf16_dynamic_ab_scheduled_matches_pallas_bf16(exact_jax):
    """FusedLTIMPPI at bf16 with a noise schedule: the staged r(inv_m bu)
    at inv_mass = 1 and r(inv_m c_t) of the scheduled step (the JAX
    kernel's drive32), per-sample costs bit for bit; then the two-phase
    normalized solve's stats at the JAX bf16 test's rtol."""
    k, c = 128, np.linspace(1.0, 0.4, TAU)
    z, x0, useq = _inputs(k, TAU, seed=13)
    make_jax, make_port = _lti_pair(k, TAU, 6, schedule=c)
    _assert_costs(_costs_both(make_jax, make_port, z, x0, useq))
    jf, mp, cp = make_jax("bfloat16")
    _, st_j = jf.solve(0, x0, useq, mp, cp,
                       z=jnp.asarray(chunk_noise(z, TILE)), use_prng=False,
                       normalize=True)
    _, st = make_port("bfloat16").solve(
        torch.as_tensor(x0), torch.as_tensor(useq), z=torch.as_tensor(z),
        normalize=True)
    for key in ("cost_min", "cost_max", "cost_mean"):
        np.testing.assert_allclose(float(st[key]), float(st_j[key]),
                                   rtol=1e-6)


def test_plain_bf16_antithetic_solve_matches_pallas_bf16(exact_jax):
    """An antithetic bf16 solve on the port's Philox stream (sample
    half + i reads -z of sample i, the XLA layout) against the JAX bf16
    solve fed those normals as injected z (its kernel mirrors in-tile
    lane pairs, another layout): the stats and the weighted noise. The
    port's solve on that stream equals its solve on the same normals
    injected, bit for bit."""
    k = 2 * K + 1
    _, x0, useq = _inputs(k, TAU, seed=17)
    args = (torch.as_tensor(x0), torch.as_tensor(useq))
    half = pm.antithetic_half(k)
    z = pm.noise_plain(3, 8, k, TAU, 3, half=half)
    assert torch.equal(z[..., half:], -z[..., :k - half])
    port = _port("bfloat16", k, antithetic=True)
    wn, st = port.solve(*args, seed=3, solve=8)
    wn_z, st_z = port.solve(*args, z=z)
    assert torch.equal(wn, wn_z)
    for key in st:
        assert torch.equal(st[key], st_z[key]), key
    jf, mp, cp = _jax("bfloat16", k)
    wn_j, st_j = jf.solve(0, x0, useq, mp, cp,
                          z=jnp.asarray(chunk_noise(z.numpy(), TILE)),
                          use_prng=False)
    for key in ("cost_min", "cost_max"):
        assert float(st[key]) == float(st_j[key]), key
    np.testing.assert_allclose(float(st["cost_mean"]),
                               float(st_j["cost_mean"]), rtol=1e-6)
    np.testing.assert_allclose(wn.numpy(), np.asarray(wn_j), rtol=1e-4,
                               atol=1e-6)
    wn32, _ = _port("float32", k, antithetic=True).solve(*args, seed=3,
                                                          solve=8)
    assert not np.allclose(wn32.numpy(), np.asarray(wn_j), rtol=1e-4,
                           atol=1e-6)


def test_plain_bf16_waypoints_match_pallas_bf16(exact_jax):
    """The point-mass waypoint cost at bf16: the quadratic around the
    queue's effective goal, rounded to bf16 as the kernel stages it, with
    the dropped constant added back in f32; again after a pop. Bit for bit
    for the queue as given; after the pop the two packages' f32 offsets
    part by an ulp (rtol 1e-6)."""
    z, x0, useq = _inputs(K, TAU, seed=19, x0=(0.25, 0.0, -0.125, 0.0,
                                                0.375, 0.0))
    ports = {cd: _port(cd, task=WAYPOINTS) for cd in ("float32", "bfloat16")}
    jaxs = {cd: _jax(cd, task=WAYPOINTS) for cd in ("float32", "bfloat16")}
    for popped in (False, True):   # the queue as given, then after a pop
        out = _costs_both(lambda cd: jaxs[cd], lambda cd: ports[cd], z, x0,
                          useq)
        if popped:
            assert_bf16_side(out["port", "bfloat16"], out["port", "float32"],
                             out["jax", "bfloat16"], out["jax", "float32"])
            np.testing.assert_allclose(out["port", "bfloat16"],
                                       out["jax", "bfloat16"], rtol=1e-6)
        else:
            _assert_costs(out)
        for cd in ports:
            ports[cd].cost.pop()
            f, mp, cp = jaxs[cd]
            jaxs[cd] = (f, mp, f.cost.pop(cp))


def test_plain_bf16_elipse_matches_pallas_bf16(exact_jax):
    """The 2D ellipse cost at (4, 2) in bf16: scaled by 1/a, a bf16 sqrt."""
    z, x0, useq = _inputs(K, TAU, adim=2, seed=7, x0=(1.5, 0.3, -0.4, 0.8))
    _assert_costs(_costs_both(
        lambda cd: _jax(cd, task=ELIPSE, sdim=4, adim=2),
        lambda cd: _port(cd, task=ELIPSE, sdim=4, adim=2), z, x0, useq))


@pytest.mark.parametrize("adim,half", [(3, 0), (6, 0), (3, 501)])
def test_bf16_noise_is_the_f32_noise_rounded(adim, half):
    """pm_noise_dump at bf16 is the f32 dump of the same seed rounded to
    bf16, element by element; the mirrored half still negates exactly."""
    z32 = pm.pm_noise_dump(9, 4, 1001, 5, adim, "cpu", half=half)
    z16 = pm.pm_noise_dump(9, 4, 1001, 5, adim, "cpu", half=half,
                           compute_dtype="bfloat16")
    assert torch.equal(z16, z32.to(torch.bfloat16).float())
    assert not torch.equal(z16, z32)
    if half:
        assert torch.equal(z16[..., half:], -z16[..., :1001 - half])


def test_bf16_weights_and_noise_sample_read_rounded_normals():
    """Phase B and the log-mode noise sample read the bf16-rounded
    normals in every phase, injected or drawn (the JAX kernels' phase B
    reads injected z unrounded; not copied)."""
    k = 300
    costs = torch.rand(k) * 10.0
    nrm = torch.tensor([0.0, 0.1])
    z = torch.randn(TAU, 3, k, generator=torch.Generator().manual_seed(2))
    for zz in (z, None):
        w16 = pm.mppi_weights(nrm, costs, TAU, 3, seed=1, solve=2, z=zz,
                              compute_dtype="bfloat16")
        zr = (pm.noise_plain(1, 2, k, TAU, 3) if zz is None else zz)
        ref = pm.weight_partials(costs, nrm,
                                 pm.round_bf16(zr).reshape(TAU * 3, k))
        torch.testing.assert_close(w16, ref, rtol=0, atol=0)
    f16 = _port("bfloat16", k)
    eps = f16.noise_sample(1, 2, max_samples=50)
    ref = torch.einsum("ij,tjn->nti", f16._scale,
                       pm.round_bf16(pm.noise_plain(1, 2, 50, TAU, 3)))
    torch.testing.assert_close(eps, ref, rtol=0, atol=0)


def test_kernel_dtype_validation():
    """ValueError for any dtype but float32 and bfloat16, and for bf16 on a
    controller that resolves to the torch path, as the JAX package
    raises; the solve objects validate too."""
    model = get_model(MODEL, dt=0.1, state_dim=6, action_dim=3, device="cpu")
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    for kw in ({"kernel_dtype": "bfloat16"},
               {"kernel_dtype": "bfloat16", "kernel": "auto"},
               {"kernel_dtype": "float16"}):
        with pytest.raises(ValueError, match="kernel_dtype"):
            MPPI(model, cost, k=10, tau=4, sigma=SIGMA, device="cpu", **kw)
    jmodel = jget_model(MODEL, dt=0.1, state_dim=6, action_dim=3)
    jcost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    with pytest.raises(ValueError, match="Pallas path only"):
        JMPPI(jmodel, jcost, k=10, tau=4, sigma=SIGMA, kernel="xla",
              kernel_dtype="bfloat16")
    for cls in (pm.FusedPointMassMPPI, pm.FusedLTIMPPI):
        with pytest.raises(ValueError, match="float32.*bfloat16"):
            cls(model, cost, k=10, tau=4, lam=LAM, upsilon=UPS, sigma=SIGMA,
                compute_dtype="float16")


def test_get_controller_reads_kernel_dtype():
    """The env key kernel-dtype reaches the controller in both packages:
    on the torch / XLA path both raise; passed on to the kernel path, the
    fused solve object is built at bf16."""
    cfg = {"samples": 40, "horizon": 4, "noise": SIGMA.tolist(),
           "kernel": "xla", "kernel-dtype": "bfloat16"}
    model = get_model(MODEL, dt=0.1, state_dim=6, action_dim=3, device="cpu")
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    with pytest.raises(ValueError, match="fused kernel path only"):
        get_controller(model, cost, cfg, device="cpu")
    jmodel = jget_model(MODEL, dt=0.1, state_dim=6, action_dim=3)
    jcost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    with pytest.raises(ValueError, match="Pallas path only"):
        jget_controller(jmodel, jcost, cfg)
    ctrl = get_controller(model, cost, {**cfg, "kernel-dtype": "float32"},
                          device="cpu")
    ctrl._kernel_dtype = "bfloat16"
    ctrl._resolve_kernel("auto", SIGMA, None)
    assert ctrl.kernel_path == "cuda"
    assert ctrl._fused.compute_dtype == ctrl._fused.consts.compute_dtype \
        == "bfloat16"


def test_bf16_closed_loop_matches_jax_bf16_solves(exact_jax):
    """Four steps of the bf16 kernel path on the CPU (the wrappers run
    their plain versions): at every step the port's weighted noise, from
    its Philox normals, against a JAX bf16 solve fed those normals as
    injected z from the same state and sequence, under the criterion; the
    f32 solves of both packages set the gap."""
    steps = 4

    def ctrl_for(cd):
        model = get_model(MODEL, dt=0.1, state_dim=6, action_dim=3,
                          device="cpu")
        cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
        ctrl = MPPI(model, cost, k=K, tau=TAU, lam=LAM, upsilon=UPS,
                    sigma=SIGMA, seed=7, device="cpu")
        ctrl._kernel_dtype = cd
        ctrl._resolve_kernel("auto", SIGMA, None)
        return ctrl, model

    ctrl, model = ctrl_for("bfloat16")
    f32 = _port("float32")
    jf = {cd: _jax(cd) for cd in ("float32", "bfloat16")}
    x = torch.tensor([0.2, 0.0, -0.1, 0.0, 0.3, 0.0])
    got = {key: [] for key in ("p16", "p32", "j16", "j32")}
    for t in range(steps):
        useq = ctrl.useq.clone()
        z = pm.noise_plain(7, t, K, TAU, 3)
        wn16, _ = ctrl._fused.solve(x, useq, seed=7, solve=t)
        a = ctrl.next(x.numpy())
        np.testing.assert_allclose(a, (useq + wn16)[0].numpy(), rtol=1e-6,
                                   atol=1e-7)
        got["p16"].append(wn16.numpy())
        wn32, _ = f32.solve(x, useq, z=z)
        got["p32"].append(wn32.numpy())
        for cd, key in (("float32", "j32"), ("bfloat16", "j16")):
            fj, mp, cp = jf[cd]
            wn, _ = fj.solve(0, x.numpy(), useq.numpy(), mp, cp,
                             z=jnp.asarray(chunk_noise(z.numpy(), TILE)),
                             use_prng=False)
            got[key].append(np.asarray(wn))
        with torch.no_grad():
            x = model.predict(x, torch.as_tensor(a, dtype=torch.float32))
    p16, p32, j16, j32 = (np.stack(got[k_]) for k_ in ("p16", "p32", "j16",
                                                       "j32"))
    assert_bf16_side(p16, p32, j16, j32)
