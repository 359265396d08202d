"""Physics: backend abstraction + built-in rigid-body solver.

Role-equivalent to the reference's physics layer (arkose/physics/backend/
base/PhysicsBackend.h:14-47 — abstract shapes box/mesh, static/dynamic
instances, impulses — implemented there by Jolt, JoltPhysicsBackend.cpp):
Jolt is C++ and not a dependency here, so the built-in backend is a sequential-impulse
rigid-body solver in the Jolt/Box2D family:

  * full 6-DoF bodies (position + quaternion orientation, linear + angular
    velocity, box/sphere inertia tensors);
  * contact generation: sphere/box vs static planes and triangle meshes,
    sphere-sphere, sphere-box, and box-box via SAT with face-clipped
    manifolds (up to 4 points — what makes stacks stable);
  * Coulomb friction (two clamped tangent impulses per contact, accumulated
    and clamped to mu * normal impulse), restitution with a velocity
    threshold, Baumgarte positional stabilization;
  * body activation: bodies whose velocities stay under threshold fall
    asleep and are skipped until an impulse or an awake contact partner
    wakes them (Jolt's activation listener semantics).

PhysicsScene syncs body transforms to render instances
(attachRenderTransform semantics, ShowcaseApp.cpp:267-292 "shoot boxes").
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np

GRAVITY = np.array([0.0, -9.81, 0.0], np.float32)

# Solver tuning (Box2D/Jolt-standard values).
SOLVER_ITERS = 10
BAUMGARTE = 0.2
SLOP = 0.005
RESTITUTION_THRESHOLD = 1.0   # m/s approach speed below which e = 0
SLEEP_LIN = 0.08              # m/s
SLEEP_ANG = 0.25              # rad/s
SLEEP_TIME = 0.5              # s below threshold before sleeping


@dataclasses.dataclass
class BodyDesc:
    shape: str                   # "sphere" | "box"
    half_extents: np.ndarray     # sphere: [r,r,r]
    mass: float = 1.0            # 0 = static
    restitution: float = 0.3
    friction: float = 0.6


class PhysicsBackend(abc.ABC):
    """Abstract backend (PhysicsBackend.h analogue)."""

    @abc.abstractmethod
    def add_body(self, desc: BodyDesc, position, velocity=(0, 0, 0)) -> int: ...

    @abc.abstractmethod
    def add_static_plane(self, normal, offset: float) -> int: ...

    @abc.abstractmethod
    def add_static_mesh(self, vertices, triangles) -> int:
        """Static triangle-mesh collider (PhysicsBackend.h:14-47's mesh
        shape — Jolt MeshShape in the reference)."""

    @abc.abstractmethod
    def apply_impulse(self, body: int, impulse) -> None: ...

    @abc.abstractmethod
    def step(self, dt: float, substeps: int = 2) -> None: ...

    @abc.abstractmethod
    def body_transform(self, body: int) -> np.ndarray: ...


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _integrate_quat(q: np.ndarray, omega: np.ndarray, h: float) -> np.ndarray:
    # dq/dt = 0.5 * (omega, 0) * q  (xyzw layout)
    ox, oy, oz = omega
    x, y, z, w = q
    dq = 0.5 * np.array([
        ox * w + oy * z - oz * y,
        oy * w + oz * x - ox * z,
        oz * w + ox * y - oy * x,
        -ox * x - oy * y - oz * z,
    ], np.float32)
    q = q + dq * h
    return q / max(np.linalg.norm(q), 1e-12)


def _tangent_basis(n: np.ndarray):
    a = np.array([0.0, 1.0, 0.0], np.float32) if abs(n[1]) < 0.9 \
        else np.array([1.0, 0.0, 0.0], np.float32)
    t1 = np.cross(n, a)
    t1 /= max(np.linalg.norm(t1), 1e-12)
    return t1, np.cross(n, t1)


@dataclasses.dataclass
class _Contact:
    a: int                 # dynamic body index
    b: int                 # other body index, or -1 for static geometry
    point: np.ndarray      # world contact point
    normal: np.ndarray     # unit, pointing from B (or static) toward A
    depth: float
    # Solver state (filled in by the stepper).
    r_a: np.ndarray = None
    r_b: np.ndarray = None
    mass_n: float = 0.0
    mass_t1: float = 0.0
    mass_t2: float = 0.0
    t1: np.ndarray = None
    t2: np.ndarray = None
    bias: float = 0.0
    p_n: float = 0.0
    p_t1: float = 0.0
    p_t2: float = 0.0


class BuiltinPhysicsBackend(PhysicsBackend):
    """Sequential-impulse rigid-body solver (fixed step)."""

    def __init__(self):
        self.pos: list[np.ndarray] = []
        self.vel: list[np.ndarray] = []
        self.quat: list[np.ndarray] = []    # xyzw
        self.omega: list[np.ndarray] = []
        self.desc: list[BodyDesc] = []
        self._inv_mass: list[float] = []
        self._inv_inertia_body: list[np.ndarray] = []  # (3,) diagonal
        self._sleep_time: list[float] = []
        self.asleep: list[bool] = []
        self.planes: list[tuple[np.ndarray, float]] = []
        # Static mesh colliders: per-mesh (v0, e1, e2, normal, aabb_lo, aabb_hi).
        self.meshes: list[tuple] = []

    # -- scene construction ---------------------------------------------------

    def add_body(self, desc, position, velocity=(0, 0, 0)) -> int:
        self.pos.append(np.asarray(position, np.float32).copy())
        self.vel.append(np.asarray(velocity, np.float32).copy())
        self.quat.append(np.array([0, 0, 0, 1], np.float32))
        self.omega.append(np.zeros(3, np.float32))
        self.desc.append(desc)
        m = float(desc.mass)
        self._inv_mass.append(1.0 / m if m > 0 else 0.0)
        he = np.asarray(desc.half_extents, np.float32)
        if m > 0:
            if desc.shape == "sphere":
                i = 0.4 * m * float(he[0]) ** 2
                inertia = np.array([i, i, i], np.float32)
            else:
                ex, ey, ez = (2.0 * he) ** 2
                inertia = (m / 12.0) * np.array(
                    [ey + ez, ex + ez, ex + ey], np.float32
                )
            self._inv_inertia_body.append(1.0 / inertia)
        else:
            self._inv_inertia_body.append(np.zeros(3, np.float32))
        self._sleep_time.append(0.0)
        self.asleep.append(False)
        return len(self.pos) - 1

    def add_static_plane(self, normal, offset: float) -> int:
        n = np.asarray(normal, np.float32)
        self.planes.append((n / np.linalg.norm(n), float(offset)))
        return len(self.planes) - 1

    def add_static_mesh(self, vertices, triangles) -> int:
        """World-space triangle soup as a static collider. Dynamic bodies
        collide via closest-point-on-triangle against their bounding sphere
        (boxes use their inscribed sphere — the builtin backend's
        approximation; the reference gets exact box-vs-mesh from Jolt)."""
        v = np.asarray(vertices, np.float32)
        t = np.asarray(triangles, np.int64).reshape(-1, 3)
        p0 = v[t[:, 0]]
        e1 = v[t[:, 1]] - p0
        e2 = v[t[:, 2]] - p0
        n = np.cross(e1, e2)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        good = norm[:, 0] > 1e-12
        p0, e1, e2, n = p0[good], e1[good], e2[good], n[good] / norm[good]
        tv = np.stack([p0, p0 + e1, p0 + e2], axis=1)
        lo = tv.min(axis=1)
        hi = tv.max(axis=1)
        self.meshes.append((p0, e1, e2, n, lo, hi))
        return len(self.meshes) - 1

    @staticmethod
    def _closest_on_triangles(p, p0, e1, e2):
        """Vectorized closest point on each triangle to point p (Ericson,
        'Real-Time Collision Detection' 5.1.5). Returns (T, 3) points."""
        ap = p[None, :] - p0
        d1 = (e1 * ap).sum(-1)
        d2 = (e2 * ap).sum(-1)
        a = (e1 * e1).sum(-1)
        b = (e1 * e2).sum(-1)
        c = (e2 * e2).sum(-1)
        det = np.maximum(a * c - b * b, 1e-20)
        u = np.clip((c * d1 - b * d2) / det, 0.0, 1.0)
        w = np.clip((a * d2 - b * d1) / det, 0.0, 1.0)
        over = u + w > 1.0
        # Clamp to the diagonal edge where the unconstrained solution leaves
        # the triangle, then re-clamp each edge parameter.
        if over.any():
            bp = p[None, :] - (p0 + e1)
            d3 = ((e2 - e1) * bp).sum(-1)
            ec = ((e2 - e1) ** 2).sum(-1)
            t_d = np.clip(d3 / np.maximum(ec, 1e-20), 0.0, 1.0)
            u = np.where(over, 1.0 - t_d, u)
            w = np.where(over, t_d, w)
        # Edge/vertex regions: clamp the independent parameters too.
        u = np.clip(u, 0.0, 1.0)
        w = np.clip(w, 0.0, 1.0)
        s_sum = u + w
        scale = np.where(s_sum > 1.0, 1.0 / s_sum, 1.0)
        u *= scale
        w *= scale
        return p0 + u[:, None] * e1 + w[:, None] * e2

    # -- runtime API ------------------------------------------------------------

    def apply_impulse(self, body: int, impulse) -> None:
        d = self.desc[body]
        if d.mass > 0:
            self.vel[body] = (
                self.vel[body] + np.asarray(impulse, np.float32) / d.mass
            )
            self._wake(body)

    def _wake(self, i: int) -> None:
        self.asleep[i] = False
        self._sleep_time[i] = 0.0

    def body_transform(self, body: int) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _quat_to_mat(self.quat[body])
        m[:3, 3] = self.pos[body]
        return m

    # -- contact generation -------------------------------------------------

    def _corners(self, i: int) -> np.ndarray:
        he = np.asarray(self.desc[i].half_extents, np.float32)
        sel = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float32)
        r = _quat_to_mat(self.quat[i])
        return self.pos[i][None, :] + (sel * he[None, :]) @ r.T

    def _collect_contacts(self) -> list[_Contact]:
        contacts: list[_Contact] = []
        nb = len(self.pos)
        for i in range(nb):
            if self.desc[i].mass <= 0:
                continue
            contacts += self._static_contacts(i)
        for i in range(nb):
            for j in range(i + 1, nb):
                di, dj = self.desc[i], self.desc[j]
                if di.mass <= 0 and dj.mass <= 0:
                    continue
                contacts += self._pair_contacts(i, j)
        return contacts

    def _static_contacts(self, i: int) -> list[_Contact]:
        out: list[_Contact] = []
        d = self.desc[i]
        p = self.pos[i]
        if d.shape == "sphere":
            r = float(d.half_extents[0])
            for n, off in self.planes:
                depth = off + r - float(np.dot(n, p))
                if depth > -SLOP:
                    out.append(_Contact(i, -1, p - n * r, n.copy(), depth))
        else:
            # Box vs plane: corner contacts — the multi-point manifold that
            # holds a resting box (and a stack) without rocking.
            corners = self._corners(i)
            for n, off in self.planes:
                dist = corners @ n - off
                for k in np.nonzero(dist < SLOP)[0]:
                    out.append(_Contact(i, -1, corners[k], n.copy(),
                                        float(-dist[k])))
        # Triangle meshes: bounding/inscribed sphere vs closest point.
        r_m = float(min(d.half_extents))
        for p0, e1, e2, tn, lo, hi in self.meshes:
            near = ((p[None, :] + r_m >= lo) & (p[None, :] - r_m <= hi)).all(1)
            if not near.any():
                continue
            cp = self._closest_on_triangles(p, p0[near], e1[near], e2[near])
            delta = p[None, :] - cp
            dist = np.linalg.norm(delta, axis=-1)
            k = int(np.argmin(dist))
            depth = r_m - dist[k]
            if depth > -SLOP:
                cn = delta[k] / dist[k] if dist[k] > 1e-9 else tn[near][k]
                out.append(_Contact(i, -1, cp[k], cn.astype(np.float32),
                                    float(depth)))
        return out

    def _pair_contacts(self, i: int, j: int) -> list[_Contact]:
        di, dj = self.desc[i], self.desc[j]
        if di.shape == "sphere" and dj.shape == "sphere":
            ri = float(di.half_extents[0])
            rj = float(dj.half_extents[0])
            d = self.pos[i] - self.pos[j]
            dist = float(np.linalg.norm(d))
            depth = ri + rj - dist
            if depth > -SLOP:
                n = d / dist if dist > 1e-9 else np.array([0, 1, 0], np.float32)
                return [_Contact(i, j, self.pos[j] + n * rj, n, depth)]
            return []
        if di.shape == "sphere" or dj.shape == "sphere":
            s, b = (i, j) if di.shape == "sphere" else (j, i)
            return self._sphere_box(s, b)
        return self._box_box(i, j)

    def _sphere_box(self, s: int, b: int) -> list[_Contact]:
        r = float(self.desc[s].half_extents[0])
        he = np.asarray(self.desc[b].half_extents, np.float32)
        rot = _quat_to_mat(self.quat[b])
        local = rot.T @ (self.pos[s] - self.pos[b])
        cp_local = np.clip(local, -he, he)
        cp = self.pos[b] + rot @ cp_local
        d = self.pos[s] - cp
        dist = float(np.linalg.norm(d))
        depth = r - dist
        if depth <= -SLOP:
            return []
        if dist > 1e-9:
            n = d / dist
        else:   # center inside the box: push out along the shallowest face
            k = int(np.argmin(he - np.abs(local)))
            n = rot[:, k] * np.sign(local[k])
            depth = r + float(he[k] - abs(local[k]))
        # Normal points from the box toward the sphere: contact (a=s, b=b).
        return [_Contact(s, b, cp, n.astype(np.float32), depth)]

    def _box_box(self, i: int, j: int) -> list[_Contact]:
        """OBB-OBB via SAT; face-clipped manifold on a face axis, closest
        edge points on an edge axis (the Box2D/ODE 'dBoxBox' recipe)."""
        he_a = np.asarray(self.desc[i].half_extents, np.float32)
        he_b = np.asarray(self.desc[j].half_extents, np.float32)
        ra = _quat_to_mat(self.quat[i])
        rb = _quat_to_mat(self.quat[j])
        d = self.pos[j] - self.pos[i]

        best_depth = np.inf
        best_axis = None
        best_kind = None  # ("face_a", k) | ("face_b", k) | ("edge", ka, kb)

        def test(axis, kind):
            nonlocal best_depth, best_axis, best_kind
            ln = np.linalg.norm(axis)
            if ln < 1e-9:
                return True
            axis = axis / ln
            proj_a = np.abs(axis @ ra) @ he_a
            proj_b = np.abs(axis @ rb) @ he_b
            sep = abs(float(axis @ d))
            depth = proj_a + proj_b - sep
            if depth < -SLOP:
                return False
            # Bias face axes slightly: edge manifolds are single-point and
            # face manifolds identical-depth should win (standard trick).
            eff = depth if kind[0] != "edge" else depth * 1.05 + 1e-4
            if eff < best_depth:
                best_depth = eff
                best_axis = axis if axis @ d >= 0 else -axis  # A -> B
                best_kind = kind
            return True

        for k in range(3):
            if not test(ra[:, k], ("face_a", k)):
                return []
        for k in range(3):
            if not test(rb[:, k], ("face_b", k)):
                return []
        for ka in range(3):
            for kb in range(3):
                if not test(np.cross(ra[:, ka], rb[:, kb]), ("edge", ka, kb)):
                    return []

        n_ab = best_axis  # from A toward B
        if best_kind[0] == "edge":
            # Closest points between the two supporting edges.
            _, ka, kb = best_kind
            pa = self.pos[i] + ra @ (
                np.sign(ra.T @ n_ab) * he_a * (np.arange(3) != ka)
            ).astype(np.float32)
            pb = self.pos[j] + rb @ (
                np.sign(rb.T @ -n_ab) * he_b * (np.arange(3) != kb)
            ).astype(np.float32)
            ua, ub = ra[:, ka], rb[:, kb]
            r_ab = pb - pa
            a11 = 1.0
            a12 = -float(ua @ ub)
            a22 = 1.0
            b1 = float(ua @ r_ab)
            b2 = -float(ub @ r_ab)
            det = a11 * a22 - a12 * a12
            s = (b1 * a22 - b2 * a12) / det if abs(det) > 1e-9 else 0.0
            t = (b2 * a11 - b1 * a12) / det if abs(det) > 1e-9 else 0.0
            point = 0.5 * (pa + ua * s + pb + ub * t)
            # Contact normal points from B toward A by convention.
            return [_Contact(i, j, point.astype(np.float32),
                             (-n_ab).astype(np.float32), float(best_depth))]

        # Face contact: clip the incident face of the OTHER box against the
        # reference face's side planes; keep points behind the face.
        if best_kind[0] == "face_a":
            ref_i, inc_i = i, j
            ref_r, inc_r = ra, rb
            ref_he, inc_he = he_a, he_b
            ref_n = n_ab          # outward from ref box (toward inc)
        else:
            ref_i, inc_i = j, i
            ref_r, inc_r = rb, ra
            ref_he, inc_he = he_b, he_a
            ref_n = -n_ab
        k_ref = best_kind[1]
        ref_axis = ref_r[:, k_ref]
        sign_ref = 1.0 if float(ref_axis @ ref_n) >= 0 else -1.0
        face_center = (self.pos[ref_i]
                       + sign_ref * ref_he[k_ref] * ref_axis)
        # Incident face: the face of inc most anti-parallel to ref_n.
        dots = inc_r.T @ ref_n
        k_inc = int(np.argmax(np.abs(dots)))
        sign_inc = -np.sign(dots[k_inc]) or 1.0
        inc_c = self.pos[inc_i] + sign_inc * inc_he[k_inc] * inc_r[:, k_inc]
        u_axes = [a for a in range(3) if a != k_inc]
        u0 = inc_r[:, u_axes[0]] * inc_he[u_axes[0]]
        u1 = inc_r[:, u_axes[1]] * inc_he[u_axes[1]]
        poly = [inc_c + sx * u0 + sy * u1
                for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
        # Clip against the 4 side planes of the reference face.
        for a in range(3):
            if a == k_ref:
                continue
            for sgn in (-1.0, 1.0):
                pn = sgn * ref_r[:, a]
                pd = float(pn @ self.pos[ref_i]) + ref_he[a]
                clipped = []
                m = len(poly)
                for v in range(m):
                    cur, nxt = poly[v], poly[(v + 1) % m]
                    dc = pd - float(pn @ cur)
                    dn = pd - float(pn @ nxt)
                    if dc >= 0:
                        clipped.append(cur)
                    if (dc >= 0) != (dn >= 0):
                        t = dc / (dc - dn)
                        clipped.append(cur + (nxt - cur) * t)
                poly = clipped
                if not poly:
                    return []
        out = []
        face_n = sign_ref * ref_axis
        for v in poly:
            depth = float(face_n @ (face_center - v))
            if depth > -SLOP:
                # Contact normal convention: from B (j) toward A (i), and
                # n_ab points A -> B regardless of which box owned the face.
                out.append(_Contact(i, j, v.astype(np.float32),
                                    (-n_ab).astype(np.float32), depth))
        # Keep the 4 deepest (standard manifold reduction).
        out.sort(key=lambda c: -c.depth)
        return out[:4]

    # -- solver ---------------------------------------------------------------

    def _inv_inertia_world(self, i: int) -> np.ndarray:
        r = _quat_to_mat(self.quat[i])
        return (r * self._inv_inertia_body[i][None, :]) @ r.T

    def step(self, dt: float, substeps: int = 2) -> None:
        h = dt / substeps
        for _ in range(substeps):
            self._substep(h)

    def _substep(self, h: float) -> None:
        nb = len(self.pos)
        dyn = [i for i in range(nb)
               if self.desc[i].mass > 0 and not self.asleep[i]]
        for i in dyn:
            self.vel[i] = self.vel[i] + GRAVITY * h

        contacts = self._collect_contacts()
        # Wake sleeping bodies touched by an awake moving partner.
        for c in contacts:
            if c.b >= 0:
                for x, y in ((c.a, c.b), (c.b, c.a)):
                    if (self.asleep[x] and not self.asleep[y]
                            and np.linalg.norm(self.vel[y]) > 2 * SLEEP_LIN):
                        self._wake(x)
        contacts = [
            c for c in contacts
            if not (self.asleep[c.a] and (c.b < 0 or self.asleep[c.b]))
        ]

        inv_i_w = {i: self._inv_inertia_world(i) for i in range(nb)
                   if self.desc[i].mass > 0}

        def vel_at(i, r):
            return self.vel[i] + np.cross(self.omega[i], r)

        # Precompute effective masses + bias; warm data lives per-contact.
        for c in contacts:
            c.r_a = c.point - self.pos[c.a]
            im = self._inv_mass[c.a]
            ii_a = inv_i_w.get(c.a, np.zeros((3, 3), np.float32))
            if c.b >= 0:
                c.r_b = c.point - self.pos[c.b]
                im_b = self._inv_mass[c.b]
                ii_b = inv_i_w.get(c.b, np.zeros((3, 3), np.float32))
            else:
                c.r_b = np.zeros(3, np.float32)
                im_b = 0.0
                ii_b = np.zeros((3, 3), np.float32)

            def k_for(axis):
                ta = np.cross(c.r_a, axis)
                tb = np.cross(c.r_b, axis)
                return (im + im_b + float(ta @ ii_a @ ta)
                        + float(tb @ ii_b @ tb))

            c.t1, c.t2 = _tangent_basis(c.normal)
            c.mass_n = 1.0 / max(k_for(c.normal), 1e-9)
            c.mass_t1 = 1.0 / max(k_for(c.t1), 1e-9)
            c.mass_t2 = 1.0 / max(k_for(c.t2), 1e-9)
            v_rel = vel_at(c.a, c.r_a)
            if c.b >= 0 and self.desc[c.b].mass > 0:
                v_rel = v_rel - vel_at(c.b, c.r_b)
            vn = float(v_rel @ c.normal)
            e_a = self.desc[c.a].restitution
            e = e_a if c.b < 0 else 0.5 * (e_a + self.desc[c.b].restitution)
            rest = -e * vn if vn < -RESTITUTION_THRESHOLD else 0.0
            # max(), not sum: Baumgarte recovery stacked ON TOP of the
            # restitution bounce injects energy (measured e_eff 0.65 for
            # e = 0.5 on the drop test).
            c.bias = max(BAUMGARTE / h * max(c.depth - SLOP, 0.0), rest)

        def apply(i, r, p, sign):
            if self.desc[i].mass <= 0 or self.asleep[i]:
                return
            self.vel[i] = self.vel[i] + sign * p * self._inv_mass[i]
            self.omega[i] = self.omega[i] + sign * (inv_i_w[i] @ np.cross(r, p))

        for _ in range(SOLVER_ITERS):
            for c in contacts:
                v_rel = vel_at(c.a, c.r_a)
                if c.b >= 0 and self.desc[c.b].mass > 0:
                    v_rel = v_rel - vel_at(c.b, c.r_b)
                vn = float(v_rel @ c.normal)
                j = (-vn + c.bias) * c.mass_n
                new_p = max(c.p_n + j, 0.0)
                j = new_p - c.p_n
                c.p_n = new_p
                imp = j * c.normal
                apply(c.a, c.r_a, imp, +1.0)
                if c.b >= 0:
                    apply(c.b, c.r_b, imp, -1.0)

                # Coulomb friction: two tangent impulses, each accumulated
                # and clamped to the friction cone mu * p_n.
                mu_a = self.desc[c.a].friction
                mu = mu_a if c.b < 0 else np.sqrt(
                    mu_a * self.desc[c.b].friction
                )
                max_t = mu * c.p_n
                v_rel = vel_at(c.a, c.r_a)
                if c.b >= 0 and self.desc[c.b].mass > 0:
                    v_rel = v_rel - vel_at(c.b, c.r_b)
                for t_ax, m_t, attr in ((c.t1, c.mass_t1, "p_t1"),
                                        (c.t2, c.mass_t2, "p_t2")):
                    vt = float(v_rel @ t_ax)
                    jt = -vt * m_t
                    old = getattr(c, attr)
                    new = float(np.clip(old + jt, -max_t, max_t))
                    jt = new - old
                    setattr(c, attr, new)
                    imp = jt * t_ax
                    apply(c.a, c.r_a, imp, +1.0)
                    if c.b >= 0:
                        apply(c.b, c.r_b, imp, -1.0)
                    v_rel = vel_at(c.a, c.r_a)
                    if c.b >= 0 and self.desc[c.b].mass > 0:
                        v_rel = v_rel - vel_at(c.b, c.r_b)

        for i in dyn:
            if self.asleep[i]:
                continue
            self.pos[i] = self.pos[i] + self.vel[i] * h
            self.quat[i] = _integrate_quat(self.quat[i], self.omega[i], h)
            # Project out of static planes (position-level, velocity kept):
            # a fast body can tunnel v*h deep in the impact substep before
            # its contact exists; projection caps visible penetration while
            # leaving the full impact speed for next substep's restitution.
            d = self.desc[i]
            for n, off in self.planes:
                if d.shape == "sphere":
                    support = float(d.half_extents[0])
                    depth = off + support - float(np.dot(n, self.pos[i]))
                else:
                    depth = float(off - (self._corners(i) @ n).min())
                if depth > 0.0:
                    self.pos[i] = self.pos[i] + n * depth
            # Activation: fall asleep after SLEEP_TIME below both thresholds.
            if (np.linalg.norm(self.vel[i]) < SLEEP_LIN
                    and np.linalg.norm(self.omega[i]) < SLEEP_ANG):
                self._sleep_time[i] += h
                if self._sleep_time[i] >= SLEEP_TIME:
                    self.asleep[i] = True
                    self.vel[i] = np.zeros(3, np.float32)
                    self.omega[i] = np.zeros(3, np.float32)
            else:
                self._sleep_time[i] = 0.0


@dataclasses.dataclass
class PhysicsScene:
    """Binds physics bodies to render instances (PhysicsScene analogue:
    attachRenderTransform, commit to renderer each frame)."""

    backend: PhysicsBackend
    scene: object  # scene.Scene

    def __post_init__(self):
        self._bindings: list[tuple[int, int]] = []  # (body, instance index)

    def attach(self, body: int, instance_index: int):
        self._bindings.append((body, instance_index))

    def commit(self):
        """Write body transforms into the scene's instance list; the caller
        rebuilds/uploads instance transforms (Scene::update physics step)."""
        for body, inst in self._bindings:
            sid, world, prev, clip, lod_band = self.scene.instances[inst]
            new_world = self.backend.body_transform(body)
            self.scene.instances[inst] = (sid, new_world, world, clip, lod_band)
