"""Quaternion operations (xyzw convention), batched over leading axes.

Quaternions are stored as ``[qx, qy, qz, qw]`` (scalar last), matching the
AUV state layout ``[x y z | qx qy qz qw | u v w p q r]`` (reference:
scripts/src/models/auv_model.py:353-398, costs/elipse_cost.py:160-179,
models/nn_model.py:564-588, which use tensorflow_graphics). Every function
takes ``[..., 4]`` / ``[..., 3]`` tensors with any leading batch shape.
"""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions. Reference: auv_model.py:426-448."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=eps)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2 (tfg quaternion.multiply)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        x1 * w2 + y1 * z2 - z1 * y2 + w1 * x2,
        -x1 * z2 + y1 * w2 + z1 * x2 + w1 * y2,
        x1 * y2 - y1 * x2 + z1 * w2 + w1 * z2,
        -x1 * x2 - y1 * y2 - z1 * z2 + w1 * w2], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate (the inverse of a unit quaternion)."""
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Body-to-inertial rotation matrix. [..., 4] -> [..., 3, 3].

    The expansion of auv_model.py:353-387 (``body2inertial_transform``)."""
    x, y, z, w = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rotate(point: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate ``point`` [..., 3] by ``q`` [..., 4] (tfg quaternion.rotate)."""
    p = torch.cat([point, torch.zeros_like(point[..., :1])], dim=-1)
    return multiply(multiply(q, p), conjugate(q))[..., :3]


def attitude_jacobian(q: torch.Tensor) -> torch.Tensor:
    """T(q): body angular velocity to quaternion rate, q_dot = T(q) omega.
    [..., 4] -> [..., 4, 3]. The rows of auv_model.py:388-398, times 0.5."""
    x, y, z, w = q.unbind(-1)
    t = torch.stack([w, -z, y, z, w, -x, -y, x, w, -x, -y, -z], dim=-1)
    return 0.5 * t.reshape(q.shape[:-1] + (4, 3))


def from_rotation_matrix(R: torch.Tensor) -> torch.Tensor:
    """Quaternion of a rotation matrix by Shepperd's method, the best of four
    forms per element (tfg quaternion.from_rotation_matrix).
    [..., 3, 3] -> [..., 4]."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def form(s2, parts):
        s = torch.sqrt(torch.clamp(s2, min=1e-30))
        return torch.stack(parts(s), dim=-1) / (2.0 * s)[..., None]

    qw0 = form(1.0 + tr, lambda s: [m21 - m12, m02 - m20, m10 - m01, s * s])
    qx0 = form(1.0 + m00 - m11 - m22,
               lambda s: [s * s, m01 + m10, m02 + m20, m21 - m12])
    qy0 = form(1.0 - m00 + m11 - m22,
               lambda s: [m01 + m10, s * s, m12 + m21, m02 - m20])
    qz0 = form(1.0 - m00 - m11 + m22,
               lambda s: [m02 + m20, m12 + m21, s * s, m10 - m01])
    cond_w = (tr > 0.0)[..., None]
    cond_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond_y = (m11 >= m22)[..., None]
    q = torch.where(cond_w, qw0,
                    torch.where(cond_x, qx0, torch.where(cond_y, qy0, qz0)))
    return normalize(q)


def between_two_vectors(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Smallest-angle quaternion rotating v1 onto v2, [..., 3] each
    (tfg quaternion.between_two_vectors_3d); antiparallel vectors rotate by
    pi about an axis orthogonal to v1."""
    cross = torch.linalg.cross(v1, v2, dim=-1)
    dot = torch.sum(v1 * v2, dim=-1, keepdim=True)
    n1 = torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    n2 = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    w = n1 * n2 + dot
    q = torch.cat([cross, w], dim=-1)
    ex = v1.new_tensor([1.0, 0.0, 0.0]).expand_as(v1)
    ey = v1.new_tensor([0.0, 1.0, 0.0]).expand_as(v1)
    ortho = torch.linalg.cross(v1, ex, dim=-1)
    ortho2 = torch.linalg.cross(v1, ey, dim=-1)
    ortho = torch.where(
        torch.linalg.vector_norm(ortho, dim=-1, keepdim=True) > 1e-6, ortho,
        ortho2)
    anti = torch.cat([ortho, torch.zeros_like(w)], dim=-1)
    q = torch.where(w < 1e-10 * n1 * n2, anti, q)
    return normalize(q)


def relative_angle(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angle of the relative rotation, 2 acos(|<q1, q2>|) of the normalized
    quaternions (tfg quaternion.relative_angle). [..., 4] x 2 -> [...]."""
    dot = torch.sum(normalize(q1) * normalize(q2), dim=-1)
    return 2.0 * torch.acos(torch.abs(torch.clamp(dot, -1.0, 1.0)))


def to_euler(q: torch.Tensor) -> torch.Tensor:
    """Intrinsic XYZ Euler angles [roll, pitch, yaw] of a quaternion
    (tfg euler.from_quaternion)."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix of [..., 3] -> [..., 3, 3].
    Reference: auv_model.py:9-77 (skew_op)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    s = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return s.reshape(v.shape[:-1] + (3, 3))
