"""Fused AUV (Fossen 6-DoF) MPPI solve on Hopper: two CUDA kernels and their
plain PyTorch versions, and the solve object around them.

Replaces the Pallas kernels of ``mppi_tf_tpu/kernels/auv_mppi.py`` for the
rexrov2-style ``AUVModel`` with the ``StaticQuatCost``, the
``WayPointsQuatCost`` (two exact quadratics with the |dot| geodesic, both
goals and the blend weights in ``dyn``, so a pop is new data) or the
``ElipseCost3D`` (cost kinds ``COST_KINDS``):

- ``auv_fused_solve`` replaces ``_fused_auv_call`` (``_make_kernel`` in
  mode "fused"): one thread per sample rolls the Fossen dynamics (rk 1, 2
  or 4) over the horizon with the 13-state in registers, sums the cost
  sum_t [q(x_{t+1}) + rhs_z_t . z_t + nc_half z_t^T Mz z_t] + q(x_H) + u_half
  and writes the block's softmax partial row, merged by ``pm_merge``;
- ``auv_fused_costs`` replaces ``_fused_auv_costs`` (mode "costs", phase A
  of the normalized solve): costs[k] and a stats-only row per block.

Phase B (``_fused_auv_weights``) is ``pm_mppi.mppi_weights`` at adim 6, and
the noise is pm_mppi's Philox stream at adim 6: ``pm_noise_dump(seed,
solve, k, tau, 6)`` is exactly what these kernels consume. Source:
``csrc/auv_mppi.cu``.

At ``compute_dtype="bfloat16"`` the ``*_bf16`` kernels (auv_mppi.cu at
the block type bf16, ``csrc/auv_mppi_bf16.cu``) round the 13-state and
every op of the force, the Fossen state derivative, the rk stages and the
renormalisation to bf16, in the order of auv_mppi.cu's own algebra (M nu,
the cross products, the cached M^-1; not the JAX kernel's, which is
shaped differently), with the force in the JAX kernel's order u_t + c_t
(scale z_t). The renormalisation's rsqrt and the state cost run in f32 on
the widened state (goals and blend weights rounded, as the JAX kernel
reads them); the z terms are bf16 values added to the f32 cost.
``_sample_costs_bf16`` is the plain version, op for op.

The f32 kernels come in two structures of the solve constants
(``STRUCTURES``, the ``AuvStruct`` template argument): "diagonal" reads the
linear damping, the noise scale, Mz and Q as their diagonals and takes the
forward-speed damping and cog as zero, emitting no instruction for the
entries it leaves out, as the JAX kernel's trace drops zero constants;
"dense" runs every matrix dense. ``AuvConsts.structure`` is "diagonal" when
each entry it leaves out is exactly 0.0, so both give the same costs; the
plain versions are dense for both.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import quaternion as quat
from . import _build
from ._launch import check, launch, on_card, solve_words, split64
from .errors import KernelUnsupportedError
from .pm_mppi import (BLOCK, STATS, TwoPhaseSolve, _sched_block,
                      bf16_const, bf16_dot, block_partials,
                      check_compute_dtype, cost_partials, entry, fleet_dims,
                      n_vehicles, per_vehicle, round_bf16_np, sched_factors,
                      solve_noise, variant_args)

GRAVITY = 9.81
SDIM, ADIM = 13, 6
#: state costs of the kernel (``AuvCost`` in auv_mppi.cu)
COST_KINDS = {"static_quat": 0, "waypoints_quat": 1, "elipse3d": 2}
#: structures of the solve constants (``AuvStruct`` in auv_mppi.cu)
STRUCTURES = {"dense": 0, "diagonal": 1}


class Dyn:
    """Layout of the per-solve array ``dyn`` (the JAX package's ``_Dyn``),
    staged into shared memory; the same layout as the ``dyn_*`` offsets of
    auv_mppi.cu, whose ``auv_dyn_size`` the wrappers check against the
    unscheduled ``size``. A scheduled solve appends the tau factors c_t."""

    def __init__(self, tau: int, scheduled: bool = False):
        self.m_tot = 0                 # 36: total mass matrix, row-major
        self.inv_m = 36                # 36: its inverse
        self.mass = 72                 # 1
        self.goal = 73                 # 13 (waypoints: w0)
        self.x0 = 86                   # 13
        self.useq = 99                 # tau*6
        self.rhs_z = 99 + 6 * tau      # tau*6: scale^T (gamma Sigma^-1 u_t)
        self.u_half = 99 + 12 * tau    # 1: sum_t 0.5 gamma u^T Sigma^-1 u
        self.goal2 = self.u_half + 1   # 13: waypoints: w1
        self.wblend = self.goal2 + 13  # 2: waypoints: (1-a, a), or (1, 0)
        self.size = self.wblend + 2
        self.sched = _sched_block(self, tau, scheduled)


@dataclass
class AuvConsts:
    """Solve constants (the JAX kernel's compile-time ``_mc``): dt, rk, lam,
    nc_half = lam (1 - 1/upsilon) / 2, buoyancy rho V g, the damping
    matrices (quad_damp as its diagonal), cog, cob, scale = upsilon sigma,
    Mz = scale^T Sigma^-1 scale, the 10x10 cost weight Q (the quaternion
    costs), the cost kind and, for "elipse3d", the ellipse's R_plane,
    q_plane, center, axis3, mapping, gv, mS and mV; ``scheduled`` and
    ``antithetic`` are the runtime variants (launch arguments).
    ``structure`` picks the f32 kernels' instantiation from these."""

    dt: float
    rk: int
    lam: float
    nc_half: float
    buoyancy: float
    lin_damp: np.ndarray
    lin_damp_fwd: np.ndarray
    quad_damp: np.ndarray
    cog: np.ndarray
    cob: np.ndarray
    scale: np.ndarray
    Mz: np.ndarray
    Q: np.ndarray
    cost_kind: str = "static_quat"
    elipse3d: dict = field(default_factory=dict)
    scheduled: bool = False
    antithetic: bool = False
    compute_dtype: str = "float32"

    #: the constants the bf16 kernels read as bf16 (packed rounded); dt,
    #: lam, nc_half and the f32 state cost's Q or ellipse stay f32
    BF16_FIELDS = ("buoyancy", "lin_damp", "lin_damp_fwd", "quad_damp",
                   "cog", "cob", "scale", "Mz")

    #: the ellipse constants, in the order of ``Elipse3D`` in auv_mppi.cu
    ELIPSE3D = ("R_plane", "q_plane", "center", "axis3", "mapping", "gv",
                "mS", "mV")

    @functools.cached_property
    def structure(self) -> str:
        """The kernels' ``STRUCTURES`` entry: "diagonal" when every constant
        the kDiag kernels leave out is exactly 0.0 (lin_damp, scale and Mz
        off their diagonals, Q off its diagonal for the quaternion costs,
        all of lin_damp_fwd and cog) and the build is f32, else "dense"
        (the bf16 build has kDense alone). kDiag reads the diagonals where
        ``packed`` holds the dense arrays."""
        def off_diagonal(m):
            m = np.asarray(m)
            return m[~np.eye(m.shape[0], dtype=bool)]

        left_out = [off_diagonal(self.lin_damp), off_diagonal(self.scale),
                    off_diagonal(self.Mz), np.ravel(self.lin_damp_fwd),
                    np.ravel(self.cog)]
        if self.cost_kind != "elipse3d":
            left_out.append(off_diagonal(self.Q))
        diagonal = (self.compute_dtype == "float32"
                    and not any(np.count_nonzero(a) for a in left_out))
        return "diagonal" if diagonal else "dense"

    @functools.cached_property
    def packed(self) -> np.ndarray:
        """f32 host array in the order of ``AuvConsts`` in auv_mppi.cu; its
        last 100 floats are Q, or the 25 ellipse constants padded. At bf16
        the ``BF16_FIELDS`` are rounded to bf16."""
        if self.cost_kind == "elipse3d":
            tail = np.zeros(100)
            el = np.concatenate([np.ravel(self.elipse3d[n])
                                 for n in self.ELIPSE3D])
            tail[:el.size] = el
        else:
            tail = self.Q.ravel()
        f = {n: np.ravel(getattr(self, n)) for n in self.BF16_FIELDS}
        if self.compute_dtype == "bfloat16":
            f = {n: round_bf16_np(v) for n, v in f.items()}
        return np.ascontiguousarray(np.concatenate([
            [self.dt, self.lam, self.nc_half], f["buoyancy"],
            f["lin_damp"], f["lin_damp_fwd"], f["quad_damp"], f["cog"],
            f["cob"], f["scale"], f["Mz"], tail]).astype(np.float32))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _state_dot(c: dict, m_tot, inv_m, fng, x, gf):
    """The kernel's state_dot, batched: x [k, 13], gf [k, 6] -> [k, 13]."""
    q, nu = x[:, 3:7], x[:, 7:13]
    v, w = nu[:, :3], nu[:, 3:]
    rot = quat.to_rotation_matrix(q)
    pos_dot = torch.einsum("kij,kj->ki", rot, v)
    quat_dot = torch.einsum("kij,kj->ki", quat.attitude_jacobian(q), w)
    Dv = (-(nu @ c["lin_damp"].T) - nu[:, :1] * (nu @ c["lin_damp_fwd"].T)
          - c["quad_damp"] * torch.abs(nu) * nu)
    a = nu @ m_tot.T
    cross = torch.linalg.cross
    Cv = torch.cat([-cross(a[:, :3], w, dim=-1),
                    -cross(a[:, :3], v, dim=-1) - cross(a[:, 3:], w, dim=-1)],
                   dim=-1)
    r3 = rot[:, 2, :]
    fbg, fbb = r3 * fng, r3 * c["buoyancy"]
    g = -torch.cat([fbg + fbb,
                    cross(c["cog"].expand_as(fbg), fbg, dim=-1)
                    + cross(c["cob"].expand_as(fbb), fbb, dim=-1)], dim=-1)
    return torch.cat([pos_dot, quat_dot, (gf - Cv - Dv - g) @ inv_m.T],
                     dim=-1)


def _quat_cost(Q, goal, x, abs_dot: bool = False):
    """StaticQuatCost.state_cost (signed dot, clamped) on x [k, 13]; with
    ``abs_dot`` WayPointsQuatCost's geodesic |dot|."""
    dot = x[:, 3:7] @ goal[3:7]
    if abs_dot:
        dot = torch.abs(dot)
    dot = torch.clamp(dot, -1.0, 1.0)
    d = torch.cat([x[:, :3] - goal[:3], 2.0 * torch.acos(dot)[:, None],
                   x[:, 7:13] - goal[7:13]], dim=-1)
    return torch.sum((d @ Q.T) * d, dim=-1)


def _elipse3d_cost(e: dict, x):
    """ElipseCost3D.state_cost on x [k, 13] from the packed constants
    ``e`` (tensors): the position through R_plane, as the kernel takes it."""
    pf = (x[:, :3] - e["center"]) @ e["R_plane"].T
    qf = quat.multiply(e["q_plane"].expand(x.shape[0], 4), x[:, 3:7])
    p_err = torch.abs(torch.sum((pf / e["axis3"]) ** 2, dim=-1) - 1.0)
    tg = pf[:, [1, 0, 2]] * e["mapping"]
    tg = tg / torch.clamp(torch.linalg.vector_norm(tg, dim=-1, keepdim=True),
                          min=1e-12)
    x_axis = tg.new_tensor([1.0, 0.0, 0.0]).expand_as(tg)
    o_err = quat.relative_angle(quat.between_two_vectors(x_axis, tg), qf)
    v_err = torch.abs(torch.sum(x[:, 7:10] ** 2, dim=-1) - e["gv"] ** 2)
    return e["mS"] * (p_err + o_err) + e["mV"] * v_err


def _state_cost_fn(consts: "AuvConsts", dyn: torch.Tensor, lay: Dyn):
    """The kernel's state cost q(x) of ``consts.cost_kind``, reading the
    goals and blend weights from ``dyn``."""
    if consts.cost_kind == "elipse3d":
        e = {n: torch.tensor(np.asarray(v, np.float64), dtype=dyn.dtype,
                             device=dyn.device)
             for n, v in consts.elipse3d.items()}
        return lambda x: _elipse3d_cost(e, x)
    Q = torch.tensor(consts.Q, dtype=dyn.dtype, device=dyn.device)
    goal = dyn[lay.goal:lay.x0]
    if consts.cost_kind == "static_quat":
        return lambda x: _quat_cost(Q, goal, x)
    goal2 = dyn[lay.goal2:lay.wblend]
    wb = dyn[lay.wblend:lay.size]
    return lambda x: (wb[0] * _quat_cost(Q, goal, x, abs_dot=True)
                      + wb[1] * _quat_cost(Q, goal2, x, abs_dot=True))


def sample_costs_plain(consts: AuvConsts, dyn: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """Per-sample rollout costs [k] in the kernel's algebra: the Fossen
    rollout of ``AUVModel.step`` and the state cost of ``consts.cost_kind``
    over eps = c_t scale @ z, with Sigma^-1, u and the schedule folded into
    dyn; at bf16 ``_sample_costs_bf16``."""
    if consts.compute_dtype == "bfloat16":
        return _sample_costs_bf16(consts, dyn, z)
    tau, _, k = z.shape
    lay = Dyn(tau, consts.scheduled)
    ct = sched_factors(dyn, lay, tau)

    def t_(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dyn.dtype,
                            device=dyn.device)

    c = {name: t_(getattr(consts, name)) for name in (
        "lin_damp", "lin_damp_fwd", "quad_damp", "cog", "cob")}
    c["buoyancy"] = consts.buoyancy
    scale, Mz = t_(consts.scale), t_(consts.Mz)
    q = _state_cost_fn(consts, dyn, lay)
    m_tot = dyn[lay.m_tot:lay.inv_m].reshape(6, 6)
    inv_m = dyn[lay.inv_m:lay.mass].reshape(6, 6)
    fng = -dyn[lay.mass] * GRAVITY
    useq = dyn[lay.useq:lay.rhs_z].reshape(tau, 6)
    rhs_z = dyn[lay.rhs_z:lay.u_half].reshape(tau, 6)
    dt, rk = consts.dt, consts.rk

    def f(x, gf):
        return _state_dot(c, m_tot, inv_m, fng, x, gf)

    x = dyn[lay.x0:lay.useq].expand(k, SDIM)
    cost = torch.zeros(k, dtype=dyn.dtype, device=dyn.device)
    for t in range(tau):
        zt = z[t].T                                     # [k, 6]
        gf = useq[t] + (ct[t] * zt) @ scale.T
        k1 = f(x, gf)
        if rk == 1:
            x = x + dt * k1
        elif rk == 2:
            x = x + (dt / 2.0) * (k1 + f(x + dt * k1, gf))
        else:
            k2 = f(x + (dt / 2.0) * k1, gf)
            k3 = f(x + (dt / 2.0) * k2, gf)
            k4 = f(x + dt * k3, gf)
            x = x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        qn = torch.rsqrt(torch.clamp(torch.sum(x[:, 3:7] ** 2, dim=-1,
                                               keepdim=True), min=1e-24))
        x = torch.cat([x[:, :3], x[:, 3:7] * qn, x[:, 7:]], dim=-1)
        cost = (cost + q(x) + zt @ rhs_z[t] + consts.nc_half * ct[t]
                * torch.sum((zt @ Mz.T) * zt, dim=-1))
    return cost + q(x) + dyn[lay.u_half]


def _cross(u, v):
    return [u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0]]


def _state_dot_bf16(cb: dict, fng, x: list, gf: list) -> list:
    """auv_mppi.cu's state_dot at bf16, op for op: x (13) and gf (6) are
    bf16 columns [k], ``cb`` the constants and staged mass matrices as
    bf16 (host floats for the matrix rows, 0-dim tensors otherwise)."""
    qx, qy, qz, qw = x[3:7]
    nu = x[7:13]
    v, w = nu[:3], nu[3:]
    one, two, half = cb["1"], cb["2"], cb["0.5"]
    r11 = one - two * (qy * qy + qz * qz)
    r12 = two * (qx * qy - qz * qw)
    r13 = two * (qx * qz + qy * qw)
    r21 = two * (qx * qy + qz * qw)
    r22 = one - two * (qx * qx + qz * qz)
    r23 = two * (qy * qz - qx * qw)
    r31 = two * (qx * qz - qy * qw)
    r32 = two * (qy * qz + qx * qw)
    r33 = one - two * (qx * qx + qy * qy)
    xd = [r11 * v[0] + r12 * v[1] + r13 * v[2],
          r21 * v[0] + r22 * v[1] + r23 * v[2],
          r31 * v[0] + r32 * v[1] + r33 * v[2],
          half * (qw * w[0] - qz * w[1] + qy * w[2]),
          half * (qz * w[0] + qw * w[1] - qx * w[2]),
          half * (-qy * w[0] + qx * w[1] + qw * w[2]),
          half * (-qx * w[0] - qy * w[1] - qz * w[2])]
    rhs = []
    for i in range(6):
        ld = bf16_dot(cb["lin_damp"][i], nu)
        lf = bf16_dot(cb["lin_damp_fwd"][i], nu)
        dv = (-ld - nu[0] * lf
              - cb["quad_damp"][i] * (torch.abs(nu[i]) * nu[i]))
        rhs.append(gf[i] - dv)
    a = [bf16_dot(row, nu) for row in cb["m_tot"]]
    c1, c2, c3 = _cross(a[:3], w), _cross(a[:3], v), _cross(a[3:], w)
    for i in range(3):
        rhs[i] = rhs[i] + c1[i]
        rhs[3 + i] = rhs[3 + i] + (c2[i] + c3[i])
    buoy = cb["buoyancy"]
    fbg = [r31 * fng, r32 * fng, r33 * fng]
    fbb = [r31 * buoy, r32 * buoy, r33 * buoy]
    mbg, mbb = _cross(cb["cog"], fbg), _cross(cb["cob"], fbb)
    for i in range(3):
        rhs[i] = rhs[i] + (fbg[i] + fbb[i])
        rhs[3 + i] = rhs[3 + i] + (mbg[i] + mbb[i])
    return xd + [bf16_dot(row, rhs) for row in cb["inv_m"]]


def _sample_costs_bf16(consts: AuvConsts, dyn: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's per-sample costs [k], op for op (auv_mppi.cu at
    Val = bf16x2): bf16 state columns, the rk step of ``consts.rk``, the f32
    rsqrt and state cost on the widened state, the z terms as bf16
    values summed in f32."""
    tau, _, k = z.shape
    lay = Dyn(tau, consts.scheduled)
    d = dyn.to(torch.float32)
    dev = d.device

    def r(v):
        return v.to(torch.bfloat16)

    def c(v):
        return bf16_const(v, dev)

    def rows(m):
        return np.float32(m).astype(float).tolist()

    def mat(lo, hi):   # a staged (rounded) 6x6 block of dyn, dense rows
        return [list(row.unbind()) for row in r(d[lo:hi]).reshape(6, 6)]

    cb = {"1": c(1.0), "2": c(2.0), "0.5": c(0.5),
          "lin_damp": rows(consts.lin_damp),
          "lin_damp_fwd": rows(consts.lin_damp_fwd),
          "quad_damp": [c(v) for v in np.ravel(consts.quad_damp)],
          "cog": [c(v) for v in np.ravel(consts.cog)],
          "cob": [c(v) for v in np.ravel(consts.cob)],
          "buoyancy": c(consts.buoyancy),
          "m_tot": mat(lay.m_tot, lay.inv_m),
          "inv_m": mat(lay.inv_m, lay.mass)}
    scale, Mz = rows(consts.scale), rows(consts.Mz)
    # the state cost reads the goals and blend weights rounded (d_())
    dq = d.clone()
    for lo, hi in ((lay.goal, lay.x0), (lay.goal2, lay.wblend + 2)):
        dq[lo:hi] = r(d[lo:hi]).float()
    q = _state_cost_fn(consts, dq, lay)
    fng = r(-d[lay.mass] * GRAVITY)
    useq = r(d[lay.useq:lay.rhs_z]).reshape(tau, 6)
    rhs_z = r(d[lay.rhs_z:lay.u_half]).reshape(tau, 6)
    ct = sched_factors(d, lay, tau)
    dt32 = np.float32(consts.dt)
    dt, h, h6 = c(dt32), c(np.float32(0.5) * dt32), c(dt32 / np.float32(6))
    nc_half = torch.as_tensor(np.float32(consts.nc_half), device=dev)

    def f(x, gf):
        return _state_dot_bf16(cb, fng, x, gf)

    def axpy(x, s, kk):
        return [xi + s * ki for xi, ki in zip(x, kk)]

    zb = r(z.to(torch.float32))
    x = [r(v).expand(k) for v in d[lay.x0:lay.useq].unbind()]
    cost = torch.zeros(k, dtype=torch.float32, device=dev)
    for t in range(tau):
        zt = list(zb[t].unbind())
        c_t = r(torch.as_tensor(ct[t], dtype=torch.float32, device=dev))
        gf = [useq[t, i] + c_t * bf16_dot(scale[i], zt) for i in range(6)]
        k1 = f(x, gf)
        if consts.rk == 1:
            x = axpy(x, dt, k1)
        elif consts.rk == 2:
            k2 = f(axpy(x, dt, k1), gf)
            x = axpy(x, h, [a + b for a, b in zip(k1, k2)])
        else:
            kk = f(axpy(x, h, k1), gf)
            acc = axpy(k1, cb["2"], kk)
            kk = f(axpy(x, h, kk), gf)
            acc = axpy(acc, cb["2"], kk)
            kk = f(axpy(x, dt, kk), gf)
            x = axpy(x, h6, [a + b for a, b in zip(acc, kk)])
        s2 = x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]
        inv = r(torch.rsqrt(torch.clamp(s2.float(), min=1e-24)))
        x = x[:3] + [xi * inv for xi in x[3:7]] + x[7:]
        cost = cost + q(torch.stack(x, dim=-1).float())
        quad = None
        for j in range(6):
            cost = cost + (rhs_z[t, j] * zt[j]).float()
            term = zt[j] * bf16_dot(Mz[j], zt)
            quad = term if quad is None else quad + term
        cost = cost + (r(nc_half * ct[t]) * quad).float()
    cost = cost + q(torch.stack(x, dim=-1).float()) + d[lay.u_half]
    return cost.to(dyn.dtype)


def fused_solve_plain(consts: AuvConsts, dyn: torch.Tensor, k: int,
                      tau: int, seed: int = 0, solve: int = 0, z=None,
                      block: int = BLOCK) -> torch.Tensor:
    """Plain version of ``auv_fused_solve``: block partials
    [n_blocks, STATS + tau*6]."""
    z = solve_noise(seed, solve, k, tau, ADIM, dyn, z,
                    consts.antithetic, consts.compute_dtype)
    costs = sample_costs_plain(consts, dyn, z)
    return block_partials(costs, z.reshape(tau * ADIM, k), consts.lam, block)


def fused_costs_plain(consts: AuvConsts, dyn: torch.Tensor, k: int,
                      tau: int, seed: int = 0, solve: int = 0, z=None,
                      block: int = BLOCK):
    """Plain version of ``auv_fused_costs``: (costs [k], stats-only rows)."""
    z = solve_noise(seed, solve, k, tau, ADIM, dyn, z,
                    consts.antithetic, consts.compute_dtype)
    costs = sample_costs_plain(consts, dyn, z)
    return costs, cost_partials(costs, block)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def kernel_dyn_size(tau: int) -> int:
    """The dyn length the CUDA kernels stage for horizon ``tau``
    (``auv_dyn_size`` of the built library)."""
    return _build.load_library().auv_dyn_size(tau)


def _check_inputs(consts, dyn, z, k, tau):
    """The vehicle axis ((), or (n,) for a fleet) of a solve's inputs."""
    if consts.rk not in (1, 2, 4):
        raise KernelUnsupportedError(f"rk must be 1, 2 or 4, got {consts.rk}")
    if kernel_dyn_size(tau) != Dyn(tau).size:
        raise RuntimeError(
            f"dyn layout mismatch: the kernels stage {kernel_dyn_size(tau)} "
            f"floats at tau={tau}, Dyn packs {Dyn(tau).size}")
    lead = fleet_dims(dyn, 1)
    check(dyn, "dyn", (*lead, Dyn(tau, consts.scheduled).size))
    if z is not None:
        check(z, "z", (*lead, tau, ADIM, k))
    return lead


def auv_fused_solve(consts: AuvConsts, dyn: torch.Tensor, k: int, tau: int,
                    seed: int = 0, solve: int = 0, z=None) -> torch.Tensor:
    """Fused Fossen rollout + block softmax partials
    [n_blocks, STATS + tau*6]; ``z`` (f32 [tau, 6, k]) injects the normals
    in place of the Philox stream of (seed, solve). A fleet's ``dyn``
    [n, size] (z [n, tau, 6, k]) runs in one launch, vehicle v drawing
    solve solve * n + v: partials [n, n_blocks, ...]."""
    if not on_card(dyn, z):
        if dyn.dim() == 2:
            return per_vehicle(lambda s, d, zv: fused_solve_plain(
                consts, d, k, tau, seed, s, zv), dyn.shape[0], solve, dyn, z)
        return fused_solve_plain(consts, dyn, k, tau, seed, solve, z)
    lead = _check_inputs(consts, dyn, z, k, tau)
    partials = torch.empty((*lead, -(-k // BLOCK), STATS + tau * ADIM),
                           dtype=torch.float32, device=dyn.device)
    launch(entry("auv_fused_solve", consts.compute_dtype), dyn.device,
           consts.rk, COST_KINDS[consts.cost_kind],
           STRUCTURES[consts.structure], consts.packed.ctypes.data,
           dyn.data_ptr(),
           None if z is None else z.data_ptr(), partials.data_ptr(), k, tau,
           *variant_args(consts, k), *split64(seed),
           *solve_words(solve, dyn.device, n_vehicles(lead)),
           n_vehicles(lead))
    return partials


def auv_fused_costs(consts: AuvConsts, dyn: torch.Tensor, k: int, tau: int,
                    seed: int = 0, solve: int = 0, z=None):
    """Phase A: per-sample costs [k] and stats-only rows [n_blocks, STATS]
    (a fleet's: [n, k] and [n, n_blocks, STATS], one launch)."""
    if not on_card(dyn, z):
        if dyn.dim() == 2:
            return per_vehicle(lambda s, d, zv: fused_costs_plain(
                consts, d, k, tau, seed, s, zv), dyn.shape[0], solve, dyn, z)
        return fused_costs_plain(consts, dyn, k, tau, seed, solve, z)
    lead = _check_inputs(consts, dyn, z, k, tau)
    costs = torch.empty((*lead, k), dtype=torch.float32, device=dyn.device)
    partials = torch.empty((*lead, -(-k // BLOCK), STATS),
                           dtype=torch.float32, device=dyn.device)
    launch(entry("auv_fused_costs", consts.compute_dtype), dyn.device,
           consts.rk, COST_KINDS[consts.cost_kind],
           STRUCTURES[consts.structure], consts.packed.ctypes.data,
           dyn.data_ptr(),
           None if z is None else z.data_ptr(), costs.data_ptr(),
           partials.data_ptr(), k, tau, *variant_args(consts, k),
           *split64(seed),
           *solve_words(solve, dyn.device, n_vehicles(lead)),
           n_vehicles(lead))
    return costs, partials


# ---------------------------------------------------------------------------
# solve object
# ---------------------------------------------------------------------------

class FusedAUVMPPI(TwoPhaseSolve):
    """Fused solve for MPPI over AUVModel + {StaticQuatCost,
    WayPointsQuatCost, ElipseCost3D}: packs ``dyn`` (the live mass
    matrices, mass, goal or the waypoint queue's two leading waypoints and
    blend weights), runs ``auv_fused_solve`` + ``pm_merge``, or the two
    phases ``auv_fused_costs`` and ``mppi_weights``, and un-folds the
    weighted normals to action units.

    Counterpart of the JAX package's ``FusedAUVMPPI``; ``antithetic`` and
    ``schedule`` are its runtime variants, ``compute_dtype`` ("float32" or
    "bfloat16", the block compute type) its build. The model is float32
    on the card; on the CPU the f32 plain versions run at the model's
    dtype.
    """

    def __init__(self, model, cost, k: int, tau: int, lam: float,
                 upsilon: float, sigma, antithetic: bool = False,
                 schedule=None, compute_dtype: str = "float32"):
        from ..costs.elipse import ElipseCost3D
        from ..costs.static import StaticQuatCost
        from ..costs.waypoints import WayPointsQuatCost
        from ..models.auv import AUVModel

        self.compute_dtype = check_compute_dtype(compute_dtype)
        if not isinstance(model, AUVModel):
            raise KernelUnsupportedError(
                "fused AUV kernel supports AUVModel only")
        kinds = {StaticQuatCost: "static_quat",
                 WayPointsQuatCost: "waypoints_quat",
                 ElipseCost3D: "elipse3d"}
        if type(cost) not in kinds:
            raise KernelUnsupportedError(
                "fused AUV kernel supports StaticQuatCost, "
                "WayPointsQuatCost or ElipseCost3D only")
        if model.device.type != "cpu" and model.dtype != torch.float32:
            raise KernelUnsupportedError(
                f"fused kernel is float32, model is {model.dtype}")
        if model.get_action_dim() != ADIM:
            raise KernelUnsupportedError(
                f"fused AUV kernel takes a 6-dim generalised force, got "
                f"action_dim={model.get_action_dim()}")
        self.model, self.cost = model, cost
        self.k, self.tau = int(k), int(tau)
        self.sdim, self.adim = SDIM, ADIM
        self.lam, self.upsilon = float(lam), float(upsilon)
        self.gamma = float(cost.gamma)
        cost_kind = kinds[type(cost)]
        sigma = np.asarray(sigma, np.float64)
        scale = self.upsilon * sigma
        inv_sigma = np.linalg.inv(sigma)

        def f64(t):
            return t.detach().cpu().numpy().astype(np.float64)

        elipse3d = {}
        if cost_kind == "elipse3d":
            q_plane = cost.q_plane.detach().cpu().double()
            elipse3d = {
                "R_plane": quat.to_rotation_matrix(q_plane).numpy(),
                "q_plane": q_plane.numpy(), "center": f64(cost.center),
                "axis3": f64(cost.axis), "mapping": f64(cost.mapping),
                "gv": cost.gv, "mS": cost.mS, "mV": cost.mV}
        like = {"dtype": model.dtype, "device": model.device}
        self._noise_options(antithetic, schedule, like)
        self.consts = AuvConsts(
            dt=model.dt, rk=model.rk, lam=self.lam,
            nc_half=0.5 * self.lam * (1.0 - 1.0 / self.upsilon),
            buoyancy=model.buoyancy, lin_damp=f64(model.lin_damp),
            lin_damp_fwd=f64(model.lin_damp_fwd),
            quad_damp=np.diag(f64(model.quad_damp)).copy(), cog=f64(model.cog),
            cob=f64(model.cob), scale=scale,
            Mz=scale.T @ inv_sigma @ scale,
            Q=np.zeros((10, 10)) if cost_kind == "elipse3d" else f64(cost.Q),
            cost_kind=cost_kind, elipse3d=elipse3d, scheduled=self.scheduled,
            antithetic=self.antithetic, compute_dtype=self.compute_dtype)
        self._scale = torch.as_tensor(scale, **like)
        self._inv_sigma = torch.as_tensor(inv_sigma, **like)

    fleet_axis = True

    def _goals(self, dtype, cp, lead: tuple) -> torch.Tensor:
        """dyn's goal (13), then goal2 (13) and wblend (2) of the waypoint
        blend: the static goal and zeros; the queue's w0, w1 and (1-a, a),
        or (1, 0) while one waypoint remains (chosen on the device); zeros
        for the ellipse, which reads none of them. From the cost's params,
        or a fleet's stacked ``cp`` ([n, 28] for vehicle axis ``lead``)."""
        kind = self.consts.cost_kind
        if cp is None:
            cp = self.cost.params()
        if kind == "waypoints_quat":
            wps = cp["waypoints"].to(dtype)
            a = (cp["count"] >= 2).to(dtype) * self.cost.alpha
            return torch.cat([wps[..., 0, :], wps[..., 1, :],
                              torch.stack([1.0 - a, a], dim=-1)], dim=-1)
        out = torch.zeros((*lead, 28), dtype=dtype, device=self.model.device)
        if kind == "static_quat":
            out[..., :13] = cp["goal"].to(dtype)
        return out

    def pack_dyn(self, x0: torch.Tensor, useq: torch.Tensor,
                 cp=None) -> torch.Tensor:
        """The per-solve ``dyn`` array ([Dyn.size], the model's dtype) from
        the state, the nominal sequence, the model's mass matrices (cached
        on the model until its parameters change), the live goals and the
        schedule; a fleet's [n, Dyn.size] from states [n, 13], sequences
        [n, tau, 6] and stacked cost params ``cp``."""
        m_tot, inv_m = self.model.precompute()
        dtype = self.model.dtype
        lead = tuple(x0.shape[:-1]) if x0.dim() == 2 else ()
        useq = useq.to(dtype).reshape(*lead, self.tau, ADIM)
        rhs_z, u_half = self._action_terms(useq)
        goals = self._goals(dtype, cp, lead)

        def row(t):   # a shared entry, repeated a vehicle
            return t.reshape(-1).expand(*lead, t.numel())

        return torch.cat([
            row(m_tot.detach()), row(inv_m.detach()),
            row(self.model.mass.detach()), goals[..., :13],
            x0.to(dtype).reshape(*lead, SDIM),
            useq.reshape(*lead, -1), rhs_z.reshape(*lead, -1),
            u_half.reshape(*lead, 1), goals[..., 13:],
            *map(row, self._sched_tail())], dim=-1)

    def _template_args(self, mode: int) -> tuple:
        """<RK, MODE, COST, STRUCT> of auv_fused_solve_kernel."""
        c = self.consts
        return (c.rk, mode, COST_KINDS[c.cost_kind], STRUCTURES[c.structure])

    def _fused(self, dyn, seed, solve, z):
        return auv_fused_solve(self.consts, dyn, self.k, self.tau, seed=seed,
                               solve=solve, z=z)

    def _costs(self, dyn, seed, solve, z):
        return auv_fused_costs(self.consts, dyn, self.k, self.tau, seed=seed,
                               solve=solve, z=z)
