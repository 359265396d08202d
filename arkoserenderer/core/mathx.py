"""3D math: vectors, quaternions, 4x4 matrices, frustum culling.

Equivalent role to the reference's vendored arklib math library
(deps/arklib/include/ark/*.h) and arkcore/core/math/Frustum.h — pure
functions that run under BOTH NumPy and jnp via the ``xp`` keyword
(default jnp). Host-side code (camera matrices, light fitting, scene build)
passes ``xp=np``: device math belongs inside jitted functions, where each op
is not a dispatch of its own.

Precision: every matrix product that makes a position (clip, world, ray
origin, skinned vertex) asks for ``HIGHEST``, i.e. full float32. On a GPU
the default precision lets XLA run float32 products in TF32, which keeps
about three decimal digits.

Conventions (fixed across the whole framework):
  * Right-handed world space, +Y up, camera looks down -Z in view space.
  * Column-vector convention: ``p' = M @ p``; compose left-to-right as
    ``proj @ view @ model``.
  * Clip space: x,y in [-w, w]; depth in [0, w] with **reverse-Z**
    (near plane -> depth 1, far -> 0) for f32 precision. All depth
    comparisons live behind ``depth_closer``.
  * Screen/pixel space: x right, y DOWN (row-major images), pixel centers
    at integer + 0.5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a, b, xp=jnp):
    """``a @ b`` in full float32 (NumPy's own product under ``xp=np``)."""
    if xp is np:
        return a @ b
    return jnp.matmul(a, b, precision=HIGHEST)

# ---------------------------------------------------------------------------
# Vectors


def normalize(v, eps: float = 1e-20, xp=jnp):
    return v / xp.sqrt(xp.sum(v * v, axis=-1, keepdims=True) + eps)


def vdot(a, b, keepdims: bool = True, xp=jnp):
    return xp.sum(a * b, axis=-1, keepdims=keepdims)


def reflect(incident, normal, xp=jnp):
    """Reflect ``incident`` about ``normal``."""
    return incident - 2.0 * vdot(incident, normal, xp=xp) * normal


# ---------------------------------------------------------------------------
# Quaternions — stored (x, y, z, w)


def quat_identity(xp=jnp):
    return xp.array([0.0, 0.0, 0.0, 1.0], dtype=xp.float32)


def quat_from_axis_angle(axis, angle, xp=jnp):
    axis = normalize(xp.asarray(axis, dtype=xp.float32), xp=xp)
    half = 0.5 * xp.asarray(angle, dtype=xp.float32)
    s = xp.sin(half)
    return xp.concatenate([axis * s, xp.cos(half)[..., None]], axis=-1)


def quat_mul(a, b, xp=jnp):
    ax, ay, az, aw = xp.moveaxis(a, -1, 0)
    bx, by, bz, bw = xp.moveaxis(b, -1, 0)
    return xp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_rotate(q, v, xp=jnp):
    """Rotate vector(s) v by quaternion(s) q."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * xp.cross(qv, v)
    return v + qw * t + xp.cross(qv, t)


def quat_to_mat3(q, xp=jnp):
    x, y, z, w = xp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = xp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_mat3(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x,y,z,w); host-side NumPy only."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s, 0.25 * s],
            np.float32,
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4, np.float32)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q / np.linalg.norm(q)


def quat_slerp(a, b, t, xp=jnp):
    cos_half = xp.sum(a * b, axis=-1, keepdims=True)
    b = xp.where(cos_half < 0.0, -b, b)
    cos_half = xp.minimum(xp.abs(cos_half), 1.0 - 1e-7)
    half = xp.arccos(cos_half)
    sin_half = xp.sin(half)
    wa = xp.sin((1.0 - t) * half) / sin_half
    wb = xp.sin(t * half) / sin_half
    near = cos_half > 1.0 - 1e-5
    out = xp.where(near, (1.0 - t) * a + t * b, wa * a + wb * b)
    return normalize(out, xp=xp)


# ---------------------------------------------------------------------------
# 4x4 matrices — assembled constructively (no .at) so NumPy works too.


def _mat4(rows, xp=jnp):
    return xp.stack([xp.stack(r, axis=-1) for r in rows], axis=-2).astype(xp.float32)


def mat4_identity(xp=jnp):
    return xp.eye(4, dtype=xp.float32)


def translation(t, xp=jnp):
    t = xp.asarray(t, dtype=xp.float32)
    m = xp.eye(4, dtype=xp.float32)
    top = xp.concatenate([m[:3, :3], t[:, None]], axis=1)
    return xp.concatenate([top, m[3:4, :]], axis=0)


def scale(s, xp=jnp):
    s = xp.broadcast_to(xp.asarray(s, dtype=xp.float32), (3,))
    return xp.diag(xp.concatenate([s, xp.ones((1,), xp.float32)]))


def rotation(q, xp=jnp):
    return compose_trs(xp.zeros(3, xp.float32), q, xp.ones(3, xp.float32), xp=xp)


def compose_trs(t, r, s, xp=jnp):
    """translation @ rotation @ scale, the glTF node TRS order."""
    m3 = quat_to_mat3(r, xp=xp) * xp.asarray(s, dtype=xp.float32)[None, :]
    t = xp.asarray(t, dtype=xp.float32)
    top = xp.concatenate([m3, t[:, None]], axis=1)
    bottom = xp.asarray([[0.0, 0.0, 0.0, 1.0]], dtype=xp.float32)
    return xp.concatenate([top, bottom], axis=0)


def transform_points(m, p, xp=jnp):
    """(..., 4, 4) @ (..., N, 3) -> (..., N, 3) with implicit w=1."""
    r = matmul(p, xp.swapaxes(m[..., :3, :3], -1, -2), xp=xp)
    return r + m[..., None, :3, 3]


def transform_points_h(m, p, xp=jnp):
    """(4,4) @ (N,3) homogeneous -> (N,4) clip positions."""
    r = matmul(p, xp.swapaxes(m[..., :3, :3], -1, -2), xp=xp) + m[..., None, :3, 3]
    w = matmul(p, m[..., 3, :3], xp=xp) + m[..., None, 3, 3]
    return xp.concatenate([r, w[..., None]], axis=-1)


def transform_dirs(m, d, xp=jnp):
    return matmul(d, xp.swapaxes(m[..., :3, :3], -1, -2), xp=xp)


def transform_point_lanes(m, p, rows=(0, 1, 2, 3)):
    """Elementwise homogeneous transform: (4,4) m, (N,3) p -> tuple of (N,)
    clip lanes for the requested matrix rows.

    Broadcast-only formulation (no ``@``/einsum): 16 broadcast mul-adds in
    float32 fuse into the surrounding per-pixel arithmetic, where a dot over
    the N axis is a separate matrix product with a layout of its own."""
    return tuple(
        p[:, 0] * m[r, 0] + p[:, 1] * m[r, 1] + p[:, 2] * m[r, 2] + m[r, 3]
        for r in rows
    )


def normal_matrix(m, xp=jnp):
    """Inverse-transpose of the upper 3x3 (normals under non-uniform scale)."""
    return xp.swapaxes(xp.linalg.inv(m[..., :3, :3]), -1, -2)


def look_at(eye, target, up=(0.0, 1.0, 0.0), xp=jnp):
    """View matrix (world -> view), camera at eye looking at target, RH -Z fwd."""
    eye = xp.asarray(eye, dtype=xp.float32)
    f = normalize(xp.asarray(target, dtype=xp.float32) - eye, xp=xp)
    r = normalize(xp.cross(f, xp.asarray(up, dtype=xp.float32)), xp=xp)
    u = xp.cross(r, f)
    rot = xp.stack([r, u, -f], axis=0)  # rows: view axes in world space
    t = -(rot @ eye)
    top = xp.concatenate([rot, t[:, None]], axis=1)
    bottom = xp.asarray([[0.0, 0.0, 0.0, 1.0]], dtype=xp.float32)
    return xp.concatenate([top, bottom], axis=0)


def perspective_reverse_z(fov_y, aspect, near, far=None, xp=jnp):
    """Perspective projection, depth in [0,1] REVERSED (near=1, far=0).

    ``far=None`` gives the infinite-far variant. ``fov_y`` is the vertical
    field of view in radians. Y is NOT flipped here (clip +Y = up); the
    viewport transform flips to row-major screen space.
    """
    g = 1.0 / np.tan(0.5 * float(fov_y)) if xp is np else 1.0 / xp.tan(
        0.5 * xp.asarray(fov_y, xp.float32)
    )
    if far is None:
        m22, m23 = 0.0, near
    else:
        m22 = near / (far - near)
        m23 = far * near / (far - near)
    return xp.asarray(
        [
            [g / aspect, 0.0, 0.0, 0.0],
            [0.0, g, 0.0, 0.0],
            [0.0, 0.0, m22, m23],
            [0.0, 0.0, -1.0, 0.0],
        ],
        dtype=xp.float32,
    )


def orthographic_reverse_z(left, right, bottom, top, near, far, xp=jnp):
    """Ortho projection with reversed [0,1] depth (view -Z maps into depth)."""
    return xp.asarray(
        [
            [2.0 / (right - left), 0.0, 0.0, -(right + left) / (right - left)],
            [0.0, 2.0 / (top - bottom), 0.0, -(top + bottom) / (top - bottom)],
            [0.0, 0.0, 1.0 / (far - near), far / (far - near)],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=xp.float32,
    )


def apply_jitter(proj, jitter_x, jitter_y, width: int, height: int, xp=jnp):
    """Add a sub-pixel jitter (pixels) to a projection matrix.

    Convention: the projected position of any world point moves by exactly
    (+jitter_x, +jitter_y) pixels in y-down screen space — the reference's
    Halton frustum jitter mechanism (arkose/scene/camera/Camera.cpp:56-68).
    """
    delta = xp.asarray(
        [
            [0.0, 0.0, -2.0 * jitter_x / width, 0.0],
            [0.0, 0.0, 2.0 * jitter_y / height, 0.0],
            [0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0],
        ],
        dtype=xp.float32,
    )
    return proj + delta


def depth_closer(a, b):
    """True where depth ``a`` is closer to the camera than ``b`` (reverse-Z)."""
    return a > b


DEPTH_FAR = 0.0  # clear value for a reverse-Z depth buffer


# ---------------------------------------------------------------------------
# Frustum (reference: arkcore/core/math/Frustum.h:12-16)


def frustum_planes_from_matrix(view_proj, xp=jnp):
    """Extract 6 frustum planes (nx,ny,nz,d) with inward normals from a
    view-projection matrix (Gribb-Hartmann). Plane eq: n.p + d >= 0 inside.
    Order: (left, right, bottom, top, near, far); reverse-Z depth.
    """
    r = view_proj
    planes = xp.stack(
        [
            r[3] + r[0],  # left:   x > -w
            r[3] - r[0],  # right:  x <  w
            r[3] + r[1],  # bottom
            r[3] - r[1],  # top
            r[3] - r[2],  # near (reverse-Z: z < w)
            r[2],         # far  (reverse-Z: z > 0)
        ],
        axis=0,
    )
    n = xp.linalg.norm(planes[:, :3], axis=-1, keepdims=True)
    return planes / xp.maximum(n, 1e-20)


def frustum_test_spheres(planes, centers, radii, xp=jnp):
    """(6,4) planes vs (N,3)+(N,) spheres -> (N,) bool visible (conservative)."""
    d = matmul(centers, planes[:, :3].T, xp=xp) + planes[None, :, 3]  # (N, 6)
    return xp.all(d >= -radii[:, None], axis=-1)


def aabb_corners(mins, maxs, xp=jnp):
    """(...,3),(...,3) -> (...,8,3) corner points."""
    mins = xp.asarray(mins)
    maxs = xp.asarray(maxs)
    sel = np.array(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], dtype=np.float32
    )
    if xp is not np:
        sel = xp.asarray(sel)
    return mins[..., None, :] * (1.0 - sel) + maxs[..., None, :] * sel


def onb(n, xp=jnp):
    """Branchless orthonormal basis from unit vectors (Frisvad via Duff et
    al.), n: (..., 3) -> (tangent, bitangent), each (..., 3)."""
    s = xp.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t = xp.concatenate(
        [1.0 + s * n[..., 0:1] ** 2 * a, s * b, -s * n[..., 0:1]], axis=-1
    )
    bt = xp.concatenate([b, s + n[..., 1:2] ** 2 * a, -n[..., 1:2]], axis=-1)
    return t, bt


def sample_cone(axis, cos_max, u1, u2, xp=jnp):
    """Uniform solid-angle direction inside the cone around ``axis``.

    axis (..., 3) unit; cos_max scalar or (...,) cosine of the cone
    half-angle; u1, u2 (...,) uniforms. cos_max == 1 returns axis exactly
    (hard light), so callers can thread a zero radius with no branch.
    The area-light sampler behind soft sun shadows (the NRD-sigma slot's
    cone-sampled occlusion rays)."""
    t, b = onb(axis, xp=xp)
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = xp.sqrt(xp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * np.pi * u2
    d = (
        t * (xp.cos(phi) * sin_t)[..., None]
        + b * (xp.sin(phi) * sin_t)[..., None]
        + axis * cos_t[..., None]
    )
    return normalize(d, xp=xp)


def sample_disk_offset(axis, radius, u1, u2, xp=jnp):
    """Uniform point offset on the disk of ``radius`` perpendicular to
    ``axis`` (..., 3): jitters a light POSITION for spherical-source soft
    shadows (occlusion-only approximation; radius 0 -> zero offset)."""
    t, b = onb(axis, xp=xp)
    r = radius * xp.sqrt(u1)
    phi = 2.0 * np.pi * u2
    return t * (r * xp.cos(phi))[..., None] + b * (r * xp.sin(phi))[..., None]
