"""Quaternion and spatial-vector algebra, batched over leading axes.

Counterpart of quadruped_tpu/physics/math.py.  Every function takes
tensors with any leading batch shape and works on the trailing axes, with
the same formulas and the same operation order as the reference, so the
two agree to float32 rounding.

Conventions (those of the reference, verified there against MuJoCo):
  * quaternions are (w, x, y, z), unit norm
  * a free joint's linear velocity is in the WORLD frame, its angular
    velocity in the BODY frame; q' = q (x) exp(0.5 * omega_body * dt)
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis (3), broadcasting the leading axes."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product u (x) v for (w,x,y,z) quaternions."""
    w1, x1, y1, z1 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    w2, x2, y2, z2 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(norm(q, keepdim=True), min=eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q: v' = v + 2*w*(u x v) + 2*(u x (u x v))."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix from quaternion (body->world)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    row0 = torch.stack([r00, r01, r02], dim=-1)
    row1 = torch.stack([r10, r11, r12], dim=-1)
    row2 = torch.stack([r20, r21, r22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle
    return torch.cat(
        [torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1
    )


def quat_integrate(q: torch.Tensor, omega_body: torch.Tensor, dt) -> torch.Tensor:
    """q' = normalize(q (x) exp(0.5 * omega * dt)), exact axis-angle
    exponential (mju_quatIntegrate)."""
    n = norm(omega_body, keepdim=True)
    angle = n[..., 0] * dt
    axis = omega_body / torch.clamp(n, min=1e-12)
    return quat_normalize(quat_mul(q, axis_angle_to_quat(axis, angle)))


def skew(v: torch.Tensor) -> torch.Tensor:
    """3x3 cross-product (skew-symmetric) matrix."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


# Spatial (6D) algebra, Featherstone convention: motion = [omega; v],
# force = [torque; force], both in one common frame.


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x m."""
    w, vl = v[..., :3], v[..., 3:]
    mw, mv = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, mv) + cross(vl, mw)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f."""
    w, vl = v[..., :3], v[..., 3:]
    ft, ff = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, ft) + cross(vl, ff), cross(w, ff)], dim=-1)


def euler_from_quat(q: torch.Tensor):
    """Roll/pitch/yaw from quaternion (reference go1_mujoco_env.py:1017-1037)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return roll, pitch, yaw


def chol_factor(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of small SPD matrices (..., n, n): the unrolled
    right-looking rank-1 sweep of the reference.  A non-positive pivot
    gives NaN through rsqrt, which callers test for."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    cols = []
    for j in range(n):
        pivot = torch.rsqrt(A[..., j, j])
        col = A[..., :, j] * pivot[..., None]
        col = torch.where(rows >= j, col, torch.zeros((), dtype=A.dtype, device=A.device))
        cols.append(col)
        A = A - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1)


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b by forward then back substitution (two batched
    triangular solves; IEEE semantics, so a NaN factor gives NaN)."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0]
