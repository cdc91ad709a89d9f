"""Roofline accounting of the port's kernels on the card.

The port of the JAX package's ``roofline.py``, with its API:
``measure_ceilings``, the work models ``noise_work``, ``pm_work``,
``auv_work``, ``nn_work`` and ``xla_solve_work``, ``classify`` (JAX's
output keys) and ``roofline_for_workload``. Two parts:

- **The counts**: the operations and bytes of one launch of each of the
  port's kernels, from the nonzeros of the run's matrices (the kernels
  elide zeros at compile time) and the layout of their inputs and partial
  rows (``kernels/pm_mppi.py``): an FMA counts 2, a normal
  ``OPS_PER_NORMAL`` (32: Philox4x32-10 and Box-Muller), an acos 10 and an
  rsqrt 1. ``bound_ms`` turns a count into the least time the card could
  take at the datasheet peaks (``PEAK_OPS`` f32 outside the tensor cores,
  ``PEAK_BYTES`` HBM; the NN's tensor-core form ``nn_tc_bound`` at
  ``PEAK_TF32`` / ``PEAK_BF16_MMA``): the bounds of PERF.md's kernel
  table, computed here and nowhere else (``chip_smoke.py`` imports them).
  The work models split the same counts into the resources the measured
  ceilings rate: f32 operations, transcendentals, Box-Muller pairs, HBM
  bytes.
- **The ceilings**, measured on the card by the hand-written
  microbenchmarks of ``csrc/roofline.cu`` (built with the kernels), each
  timed with CUDA events: the f32 FMA rate over independent chains
  (``vpu_flops``, JAX's key, here the CUDA cores' rate), the ``__expf``
  rate (``transcendental_per_s``), the rate of Box-Muller pairs drawn
  through the kernels' own Philox and transforms (``bm_pairs_per_s``) and
  the HBM stream-read rate (``hbm_bytes_per_s``). ``measure_ceilings``
  runs on the card and raises without one unless ``device="cpu"`` asks
  for the plain torch versions (CPU rates, for tests: never a device
  metric; the result names its backend and device).

One yardstick governs: ``bound_ms`` at the datasheet peaks, the bound of
the kernel table, of ``chip_smoke.py``'s kernels line and of any row a
benchmark reports. ``classify`` (JAX's annotation) rates the same counts
against the measured ceilings and is a diagnostic beside it, not a second
bound: where they differ, the count is what the ceilings question. On the
H100 the measured pair rate makes a normal cost about four times the
``OPS_PER_NORMAL`` f32 operations that ``bound_ms`` charges, so the
datasheet bound of a noise-heavy kernel is a floor the card cannot reach.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .kernels.pm_mppi import BLOCK, STATS

#: H100 SXM published peaks (NVIDIA datasheet): HBM bytes/s, f32
#: operations/s outside the tensor cores, the dense tensor-core TF32 and
#: bf16 rates; the bf16 rollout's unfused ops (mul.rn / add.rn.bf16x2, one
#: op a lane) run at the f32 rate
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
PEAK_TF32, PEAK_BF16_MMA = 495e12, 989e12
PEAK_OPS_BF16 = PEAK_OPS
#: operations per generated normal: Philox4x32-10 is 98 integer ops per 4
#: words (10 rounds of 2 mul-hi, 2 mul-lo, 4 xor; 9 key bumps of 2 adds);
#: Box-Muller ~15 per pair (2 uniforms of 4 ops, log, mul, sqrt, sin, cos,
#: 2 muls); every op counted at the f32 rate, so the bound is a floor
OPS_PER_NORMAL = 98 / 4 + 15 / 2
#: operations of one 2D ellipse cost (pm_mppi.cu state_cost<kElipse>): two
#: centred, scaled coordinates (4), their squares summed (3), |. - 1| (2),
#: the speed (3 + sqrt 1), its error squared (2), the weighted sum (3)
ELIPSE_OPS = 18
#: operations of one 3D ellipse cost (auv_mppi.cu elipse3d_cost, FMA = 2,
#: acos 10, rsqrt 1): centring (3), R_plane (18), the scaled squares and
#: |. - 1| (11), q_plane (x) q (28), the tangent and its norm (13),
#: between_two_vectors and its norm (12), the dot, |.| and acos (19), the
#: speed error (7), the weighted sum (4)
ELIPSE3D_OPS = 115


# ---------------------------------------------------------------------------
# the counts: operations of one launch, and the datasheet bound
# ---------------------------------------------------------------------------

def nnz(a) -> int:
    return int(np.count_nonzero(a))


def solve_ops(consts, k: int, tau: int, prng: bool,
              costs_only: bool = False) -> float:
    """Operations of one fused point-mass solve, from the nonzeros of this
    run's matrices (FMA = 2): rollout and cost per sample-step, the
    terminal cost, the softmax, the w*z reduction, and one noise pass (the
    function needs each normal once; the kernel's regeneration in its
    second pass is its own choice and not counted). With ``costs_only``
    (phase A): no softmax or w*z. The state cost is the quadratic around
    dyn's goal or, for the "elipse" kind, ``ELIPSE_OPS``. A dynamic_ab
    solve's A and B scale are runtime data: counted dense, as JAX
    roofline.py:231-232 counts them. The z-quadratic (Mz z, z . Mz z and
    its scaled add) counts only where nc_half is not 0: at upsilon 1 the
    function has no such term, and the kernels skip it."""
    sdim, adim = consts.dims
    q_ops = (ELIPSE_OPS if consts.cost_kind == "elipse"
             else sdim + 2 * nnz(consts.Q) + 2 * sdim)
    ab = (sdim * (sdim + adim) if consts.dynamic_ab
          else nnz(consts.A) + nnz(consts.Bs))
    quad = 2 * nnz(consts.Mz) + 2 * adim + 2 if consts.nc_half != 0.0 else 0
    step = 2 * ab + 2 * sdim + q_ops + 2 * adim + quad
    return _rollout_ops(k, tau, adim, step, q_ops, prng, costs_only)


def _rollout_ops(k, tau, adim, step, q_ops, prng, costs_only):
    n_normals = k * tau * adim
    if costs_only:
        ops = k * (tau * step + q_ops + 1)
    else:
        ops = k * (tau * step + q_ops + 6) + 2 * n_normals
    return float(ops + (n_normals * OPS_PER_NORMAL if prng else 0))


def auv_solve_ops(consts, dyn, k: int, tau: int, prng: bool,
                  costs_only: bool = False) -> float:
    """Operations of one fused AUV solve, counted from auv_mppi.cu with the
    nonzeros of this run's matrices (FMA = 2; acos, rsqrt counted as 10 and
    1): a state_dot is the rotation (36), pose rates (18), quaternion rates
    (24), damping (2 nnz(L) + 2 nnz(L_fwd) + 36), M nu (2 nnz(M)), three
    cross products and their sums (36), restoring forces (24 + 2 nnz(cog)
    + 2 nnz(cob)), the force sum (6) and M^-1 rhs (2 nnz(M^-1)); a step adds
    the generalised force, rk stages, the quaternion norm, the state cost
    (the 10-dim quadratic; twice for "waypoints_quat", with |dot| and the
    blend; ``ELIPSE3D_OPS`` for "elipse3d") and the action-cost terms, the
    z-quadratic only where nc_half is not 0. The kDiag kernels run this
    count but for cob's zeros and M's; kDense runs the matrices dense."""
    m_tot = dyn[:36].cpu().numpy()
    inv_m = dyn[36:72].cpu().numpy()
    sd = (36 + 18 + 24 + 2 * nnz(consts.lin_damp)
          + 2 * nnz(consts.lin_damp_fwd) + 36 + 2 * nnz(m_tot) + 36
          + 24 + 2 * nnz(consts.cog) + 2 * nnz(consts.cob) + 6
          + 2 * nnz(inv_m))
    stages = {1: sd + 26, 2: 2 * sd + 26 + 39, 4: 4 * sd + 3 * 52 + 39}
    q_ops = {"static_quat": 3 + 7 + 2 + 10 + 2 + 6 + 2 * nnz(consts.Q) + 20,
             "waypoints_quat": 2 * (3 + 7 + 3 + 10 + 2 + 6
                                    + 2 * nnz(consts.Q) + 20) + 3,
             "elipse3d": ELIPSE3D_OPS}[consts.cost_kind]
    quad = 2 * nnz(consts.Mz) + 12 + 2 if consts.nc_half != 0.0 else 0
    step = (6 + 2 * nnz(consts.scale) + stages[consts.rk] + 13 + q_ops
            + 12 + quad)
    return _rollout_ops(k, tau, 6, step, q_ops, prng, costs_only)


def nn_solve_ops(consts, k: int, tau: int, prng: bool,
                 costs_only: bool = False) -> float:
    """Operations of one fused NN solve, counted from nn_mppi.cu (FMA = 2;
    acos, rsqrt as 10 and 1): a step is the action u = useq + scale z, the
    MLP (2 fan_in fan_out a layer, a ReLU per hidden unit), the delta, the
    quaternion renormalisation, the 10-dim cost and the action-cost
    terms."""
    sizes = consts.sizes
    mlp = sum(2 * i * o for i, o in zip(sizes[:-1], sizes[1:])) + sum(
        sizes[1:-1])
    q_ops = 3 + 7 + 2 + 10 + 2 + 6 + 2 * nnz(consts.Q) + 20
    step = (6 + 2 * nnz(consts.scale) + mlp + 13
            + (12 if consts.renorm else 0) + q_ops + 12 + 2 * nnz(consts.Mz)
            + 12 + 2)
    return _rollout_ops(k, tau, 6, step, q_ops, prng, costs_only)


def nn_tc_bound(consts, n_bytes: float, k: int, tau: int, prng: bool,
                costs_only: bool = False, extra: float = 0.0):
    """bound_ms of the NN body in the form nn_mppi.cu computes it: the
    MLP's mma flops (2 x fan_in x fan_out a layer and sample-step, fan_in
    padded to the mma's k, fan_out to whole n tiles of 8) at the TF32 peak,
    three products each (3xTF32), or at the bf16 peak for the
    bf16-products build, plus the rest of nn_solve_ops (its MLP
    multiply-adds taken out, the ReLUs kept) and the activations' splits
    (3 ops an A value a layer, 0.5 a value packed to bf16) and ``extra``
    operations (a noise variant's) at PEAK_OPS."""
    sizes, bfp = consts.sizes, consts.bf16_products
    kk = 16 if bfp else 8
    pairs = list(zip(sizes[:-1], sizes[1:]))
    mma = 2.0 * k * tau * sum(-(-i // kk) * kk * -(-o // 8) * 8
                              for i, o in pairs)
    t_mma = mma / PEAK_BF16_MMA if bfp else 3.0 * mma / PEAK_TF32
    split = (0.5 if bfp else 3.0) * sum(sizes[:-1])
    rest = (nn_solve_ops(consts, k, tau, prng, costs_only) + extra
            - k * tau * (sum(2 * i * o for i, o in pairs) - split))
    t_o, t_b = t_mma + rest / PEAK_OPS, n_bytes / PEAK_BYTES
    return max(t_o, t_b) * 1e3, ("bytes" if t_b >= t_o else
                                 "operations (mma at the tensor-core peak, "
                                 "the rest at 67 TFLOP/s)")


def weights_ops(k: int, n_z: int, prng: bool) -> float:
    """Phase B: the bounded exponent (4 a sample), one noise pass and the
    w*z reduction (2 a normal)."""
    return float(k * 4 + k * n_z * (2 + (OPS_PER_NORMAL if prng else 0)))


def mirror_saving(k: int, n_z: int) -> float:
    """The normals an antithetic solve of k samples need not draw: the
    mirrored k - ceil(k/2) samples' n_z each, at OPS_PER_NORMAL."""
    return (k - (k + 1) // 2) * n_z * OPS_PER_NORMAL


def sched_ops(k: int, tau: int, dims: int) -> float:
    """What the schedule adds to a solve: c_t times the noise drive of
    ``dims`` dimensions and times the z-quadratic, a sample and a step."""
    return float(k * tau * (dims + 1))


def bound_ms(n_bytes: float, ops: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes at
    PEAK_BYTES and the operations at PEAK_OPS."""
    t_b, t_o = n_bytes / PEAK_BYTES, ops / PEAK_OPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def bf16_bound(n_bytes: float, ops: float, ops_bf16: float):
    """bound_ms with ``ops_bf16`` of the ``ops`` at the bf16 rate and the
    rest at the f32 rate."""
    t_b = n_bytes / PEAK_BYTES
    t_o = ops_bf16 / PEAK_OPS_BF16 + (ops - ops_bf16) / PEAK_OPS
    return (max(t_b, t_o) * 1e3,
            "bytes" if t_b >= t_o else
            "operations (unfused bf16 rollout and f32 both at 67 TFLOP/s)")


def bf16_rollout_ops(consts, k: int, tau: int, dyn=None) -> float:
    """The bf16 share of a solve's operations, from the step formulas of
    solve_ops, auv_solve_ops and nn_solve_ops: the dynamics, the
    z-quadratic and the rhs_z products of every sample-step, and the point
    mass's state cost (bf16 there); the noise, the cost sums, the softmax
    and the AUV's and NN's f32 state costs are the f32 rest."""
    adim = consts.Mz.shape[0]
    zq = 2 * nnz(consts.Mz) + 2 * adim + adim
    if hasattr(consts, "dims"):                       # the point mass
        sdim = consts.dims[0]
        q_ops = (ELIPSE_OPS if consts.cost_kind == "elipse"
                 else sdim + 2 * nnz(consts.Q) + 2 * sdim)
        ab = (sdim * (sdim + adim) if consts.dynamic_ab
              else nnz(consts.A) + nnz(consts.Bs))
        if consts.nc_half == 0.0:    # as solve_ops: no z-quadratic
            zq = adim
        return float(k * (tau * (2 * ab + 2 * sdim + q_ops + zq) + q_ops))
    if hasattr(consts, "rk"):                         # the AUV
        full = auv_solve_ops(consts, dyn, 1, 1, prng=False, costs_only=True)
        q_ops = 3 + 7 + 2 + 10 + 2 + 6 + 2 * nnz(consts.Q) + 20
        return float(k * tau * (full - 2 * q_ops - 1 - 2 - 12 + zq))
    sizes = consts.sizes                              # the NN
    mlp = sum(2 * i * o for i, o in zip(sizes[:-1], sizes[1:])) + sum(
        sizes[1:-1])
    return float(k * tau * (6 + 2 * nnz(consts.scale) + mlp + 13
                            + (12 if consts.renorm else 0) + zq))


def solve_bytes(dyn_numel: int, k: int, n_z: int,
                costs_only: bool = False) -> float:
    """Bytes one solve launch must move: dyn read, and the partial rows
    written ([ceil(k/256), STATS + n_z] f32) or, for phase A, the costs
    [k] and the stats-only rows."""
    nb = -(-k // BLOCK)
    if costs_only:
        return 4.0 * dyn_numel + 4.0 * k + 4.0 * nb * STATS
    return 4.0 * dyn_numel + 4.0 * nb * (STATS + n_z)


def weights_bytes(k: int, n_z: int) -> float:
    """Phase B: the costs and the two normalisers read, the rows
    written."""
    return 4.0 * k + 8.0 + 4.0 * -(-k // BLOCK) * (STATS + n_z)


# ---------------------------------------------------------------------------
# measured ceilings
# ---------------------------------------------------------------------------

#: work of one timed launch on the card: FMA loop iterations (x128 FMAs a
#: thread), __expf iterations (x128), Box-Muller loops (2 pairs each), the
#: stream's buffer; blocks of 256 threads, 8 an SM (2048 threads)
_CARD_ITERS = {"fma": 20_000, "expf": 2_400, "bm": 12_000}
_STREAM_BYTES = 1 << 30
_STREAM_LAUNCHES = 20


def _events_ms(fn, reps: int) -> float:
    """The least CUDA-event ms of one ``fn()`` over ``reps`` runs, after a
    warm-up run."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _card_ceilings(device: torch.device, reps: int) -> dict:
    from .kernels import _build
    from .kernels.errors import KernelLaunchError

    lib = _build.load_library()
    threads, per_iter = lib.roofline_threads(), lib.roofline_chains()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        blocks = 8 * torch.cuda.get_device_properties(
            device).multi_processor_count
        out = torch.empty(blocks * threads, device=device)

        def call(name, *args):
            rc = getattr(lib, name)(*args, stream)
            if rc != 0:
                raise KernelLaunchError(
                    f"{name} failed: {_build.error_string(rc)}")

        n_thr = blocks * threads
        it = _CARD_ITERS
        t = _events_ms(lambda: call("roofline_fma", out.data_ptr(), blocks,
                                    it["fma"], 0.9999999), reps)
        fma = 2.0 * per_iter * it["fma"] * n_thr / (t * 1e-3)
        t = _events_ms(lambda: call("roofline_expf", out.data_ptr(), blocks,
                                    it["expf"]), reps)
        expf = per_iter * it["expf"] * n_thr / (t * 1e-3)
        t = _events_ms(lambda: call("roofline_bm", out.data_ptr(), blocks,
                                    it["bm"], 12345), reps)
        pairs = 2.0 * it["bm"] * n_thr / (t * 1e-3)
        buf = torch.ones(_STREAM_BYTES // 4, device=device)
        n4 = buf.numel() // 4

        def stream_run():
            for _ in range(_STREAM_LAUNCHES):
                call("roofline_stream", buf.data_ptr(), n4, out.data_ptr(),
                     blocks)

        t = _events_ms(stream_run, reps)
        hbm = 16.0 * n4 * _STREAM_LAUNCHES / (t * 1e-3)
        del buf
    return {"vpu_flops": fma, "transcendental_per_s": expf,
            "bm_pairs_per_s": pairs, "hbm_bytes_per_s": hbm}


def _best_s(fn, reps: int) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _plain_ceilings(reps: int) -> dict:
    """The microbenchmarks' plain torch versions, on the CPU: the same four
    kinds of work at small sizes (CPU rates, no device metric)."""
    from .kernels import pm_mppi as pm

    n, iters = 1 << 16, 8
    x = torch.linspace(0.5, 1.5, n)
    c = torch.tensor(0.9999999)

    def fma():
        a, b, cc, d = x, x + 0.5, x + 1.0, x + 1.5
        for _ in range(iters):
            a, b, cc, d = (a * c + 1e-9, b * c + 2e-9, cc * c + 3e-9,
                           d * c + 4e-9)
        return a + b + cc + d

    def expf():
        y = x - 0.45
        for _ in range(iters):
            y = torch.exp(-y)
        return y

    ctr = torch.stack(torch.broadcast_tensors(
        torch.arange(n // 4, dtype=torch.int64)[:, None],
        torch.arange(iters, dtype=torch.int64)[None, :],
        torch.tensor(0), torch.tensor(0)), dim=-1)
    key = torch.tensor([12345, 0], dtype=torch.int64)
    big = torch.ones(1 << 24)
    return {
        "vpu_flops": 2.0 * 4 * iters * n / _best_s(fma, reps),
        "transcendental_per_s": iters * n / _best_s(expf, reps),
        "bm_pairs_per_s": 2.0 * ctr.shape[0] * iters / _best_s(
            lambda: pm.box_muller(pm.philox4x32_10(ctr, key)), reps),
        "hbm_bytes_per_s": 4.0 * big.numel() / _best_s(big.sum, reps),
    }


@functools.lru_cache(maxsize=None)
def _ceilings(device: str, reps: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "measure_ceilings(device='cuda'): no GPU is present; pass "
                "device='cpu' for the plain torch versions' CPU rates")
        rates = _card_ceilings(dev, reps)
        name = torch.cuda.get_device_name(dev)
    elif dev.type == "cpu":
        rates = _plain_ceilings(reps)
        name = "cpu"
    else:
        raise ValueError(f"no ceilings for device {device!r}")
    return {"backend": dev.type, "device": name, **rates}


def measure_ceilings(device="cuda", reps: int = 3) -> dict:
    """{backend, device, vpu_flops (f32 FMA, flops/s),
    transcendental_per_s (__expf), bm_pairs_per_s (Philox + Box-Muller
    pairs), hbm_bytes_per_s (stream read)}: on the card from the
    microbenchmarks of csrc/roofline.cu, the least of ``reps`` CUDA-event
    timings each, cached a device; raises without a GPU. ``device="cpu"``
    runs their plain torch versions (CPU rates)."""
    return dict(_ceilings(str(torch.device(device)), int(reps)))


# ---------------------------------------------------------------------------
# work models: the counts split by resource
# ---------------------------------------------------------------------------

def noise_work(k: int, tau: int, adim: int, antithetic: bool = False):
    """The noise of one pass: k tau adim normals as Box-Muller pairs (the
    bm_pairs_per_s ceiling rates the Philox words and the transforms
    together); an antithetic solve draws ceil(k/2) samples' normals."""
    drawn = (k + 1) // 2 if antithetic else k
    return {"flops": 0.0, "trans": 0, "bm_pairs": drawn * tau * adim / 2.0}


def _rest_dyn(fused) -> torch.Tensor:
    """A solve object's dyn at rest (zero state, a unit quaternion for the
    13-dim ones, a zero plan): its size and, for the AUV, its mass
    matrices."""
    like = {"dtype": torch.float32, "device": fused.model.device}
    x0 = torch.zeros(fused.sdim, **like)
    if fused.sdim == 13:
        x0[6] = 1.0
    return fused.pack_dyn(x0, torch.zeros(fused.tau, fused.adim, **like))


def _fused_work(fused, normalize: bool, ops, trans_per_sample: float,
                sched_dims: int, dyn_numel: int) -> dict:
    """The work of one solve of a fused object: the fused kernel, or for
    ``normalize`` the costs kernel (phase A) and phase B; ``ops(k, tau,
    prng, costs_only)`` its count."""
    k, tau, adim = fused.k, fused.tau, fused.adim
    n_z = tau * adim
    antithetic = bool(getattr(fused, "antithetic", False))
    noise = noise_work(k, tau, adim, antithetic)
    extra = sched_ops(k, tau, sched_dims) if fused.scheduled else 0.0
    if normalize:
        return {"flops": ops(k, tau, False, True) + extra
                + weights_ops(k, n_z, False),
                "trans": k * trans_per_sample + k,
                "bm_pairs": 2 * noise["bm_pairs"],
                "hbm_bytes": solve_bytes(dyn_numel, k, n_z, True)
                + weights_bytes(k, n_z)}
    return {"flops": ops(k, tau, False, False) + extra,
            "trans": k * trans_per_sample + k,
            "bm_pairs": noise["bm_pairs"],
            "hbm_bytes": solve_bytes(dyn_numel, k, n_z)}


def pm_work(fused, normalize: bool = False) -> dict:
    """Work of one fused point-mass / LTI solve (``FusedPointMassMPPI``,
    ``FusedLTIMPPI``): ``solve_ops`` without the noise, the softmax exp
    (and the ellipse's sqrt a step) as transcendentals, the normals as
    pairs, the bytes of dyn and the rows."""
    c = fused.consts
    per_sample = fused.tau + 1 if c.cost_kind == "elipse" else 0
    return _fused_work(
        fused, normalize,
        lambda k, tau, prng, co: solve_ops(c, k, tau, prng, co),
        per_sample, fused.sdim, _rest_dyn(fused).numel())


def auv_work(fused, normalize: bool = False) -> dict:
    """Work of one fused AUV solve (``FusedAUVMPPI``): ``auv_solve_ops``
    without the noise; an rsqrt a step (the quaternion's norm; two more
    for "elipse3d") and the softmax exp as transcendentals."""
    c, dyn = fused.consts, _rest_dyn(fused)
    per_step = 1 + (2 if c.cost_kind == "elipse3d" else 0)
    return _fused_work(
        fused, normalize,
        lambda k, tau, prng, co: auv_solve_ops(c, dyn, k, tau, prng, co),
        fused.tau * per_step, 6, dyn.numel())


def nn_work(fused, normalize: bool = False) -> dict:
    """Work of one fused NN solve (``FusedNNMPPI``): ``nn_solve_ops``
    without the noise (the MLP counted at the f32 rate, as JAX's model;
    ``nn_tc_bound`` is its tensor-core form), the renormalisation's rsqrt
    a step and the softmax exp as transcendentals."""
    c = fused.consts
    return _fused_work(
        fused, normalize,
        lambda k, tau, prng, co: nn_solve_ops(c, k, tau, prng, co),
        fused.tau if c.renorm else 0, 6, _rest_dyn(fused).numel())


def xla_solve_work(k: int, tau: int, adim: int, step_flops: int,
                   cost_flops: int, sdim: int) -> dict:
    """Work of the torch route (the counterpart of JAX's XLA solve): the
    same arithmetic plus the device-memory traffic it cannot avoid: the
    [K, tau, aDim] noise written, read by the rollout and read again by
    the weighted-noise contraction, and the [K, sDim] state and [K] cost
    carried through each step (read and written)."""
    eps_bytes = 4 * k * tau * adim
    carry_bytes = 4 * k * (sdim + 1) * tau * 2
    per_sample = tau * (step_flops + cost_flops + 6 * adim) + cost_flops
    return {
        "flops": k * (per_sample + 8 + 2 * tau * adim)
        + 5 * k * tau * adim,
        "trans": k,
        "bm_pairs": k * tau * adim // 2,
        "hbm_bytes": 3 * eps_bytes + carry_bytes,
    }


# ---------------------------------------------------------------------------
# row annotation
# ---------------------------------------------------------------------------

def classify(work: dict, ceil: dict, measured_ms: float):
    """Given a work model, the measured ceilings and a measured latency,
    return the roofline annotation of a row (the JAX package's keys).

    The stage bounds add (noise generation and the rollout run in the same
    pass), so the speed of light is the sum of the noise-stage and
    compute-stage times, each against its own ceiling, with HBM and the
    transcendentals as alternative binding resources."""
    t_flops = work["flops"] / ceil["vpu_flops"]
    t_trans = work.get("trans", 0) / ceil["transcendental_per_s"]
    t_noise = (work.get("bm_pairs", 0)
               / ceil.get("bm_pairs_per_s", float("inf")))
    t_hbm = work.get("hbm_bytes", 0) / ceil["hbm_bytes_per_s"]
    t_serial = t_flops + t_noise
    bounds = {"compute+noise": t_serial, "transcendental": t_trans,
              "hbm": t_hbm}
    bound = max(bounds, key=bounds.get)
    t_bound_ms = bounds[bound] * 1e3
    return {
        "flops": int(work["flops"]),
        "transcendentals": int(work.get("trans", 0)),
        "bm_pairs": int(work.get("bm_pairs", 0)),
        "hbm_bytes": int(work.get("hbm_bytes", 0)),
        "t_compute_ms": round(t_flops * 1e3, 4),
        "t_noise_ms": round(t_noise * 1e3, 4),
        "t_transcendental_ms": round(t_trans * 1e3, 4),
        "t_hbm_ms": round(t_hbm * 1e3, 4),
        "bound": bound,
        "sol_ms": round(t_bound_ms, 4),
        # the share of the binding roofline achieved (1.0: speed of light;
        # above 1 only where the work model undercounts)
        "pct_of_bound": round(t_bound_ms / measured_ms, 4)
        if measured_ms > 0 else 0.0,
        "pct_vpu_peak": round(t_flops * 1e3 / measured_ms, 4)
        if measured_ms > 0 else 0.0,
    }


#: step operations of the torch route by model: JAX's coarse table, an
#: estimate that no count of the port's torch route backs (that route is
#: bound by device memory, so 2x on its operations moves little). No row
#: reports an annotation from it until a benchmark measures that route.
_TORCH_STEP_FLOPS = {"PointMassModel": 40, "DMDModel": 90, "AUVModel": 800,
                     "NNAUVModel": 7000, "NNModel": 7000}


def roofline_for_workload(workload: str, ctrl, measured_ms: float,
                          normalize: bool = False):
    """The annotation of a row for its controller, against the ceilings
    measured on its device: the kernels' work model where the controller
    runs them, else the torch route's estimate (``_TORCH_STEP_FLOPS``).
    ``workload`` is JAX's argument; the solve is read from the
    controller."""
    del workload
    tpl = getattr(ctrl, "_tpl", ctrl)
    ceil = measure_ceilings(tpl._device)
    fused = getattr(tpl, "_fused", None)
    if fused is not None:
        from .kernels.auv_mppi import FusedAUVMPPI
        from .kernels.nn_mppi import FusedNNMPPI

        if isinstance(fused, FusedNNMPPI):
            work = nn_work(fused, normalize)
        elif isinstance(fused, FusedAUVMPPI):
            work = auv_work(fused, normalize)
        else:
            work = pm_work(fused, normalize)
    else:
        name = type(tpl._model).__name__
        work = xla_solve_work(tpl._k, tpl._tau, tpl._adim,
                              _TORCH_STEP_FLOPS.get(name, 2000), 40,
                              tpl._sdim)
    return classify(work, ceil, measured_ms)
