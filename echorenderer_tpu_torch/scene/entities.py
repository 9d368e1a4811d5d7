"""Mutable user-facing scene hierarchy.

Rebuild of the reference's Scenic layer (Scenic/Hierarchies/Entity.cs,
EntityPack.cs, Scene.cs, PackInstance.cs): a tree of entities with
TRS transforms (translation, quaternion rotation, uniform scale). All
host-side numpy; `prepare()` flattens the graph into device arrays.
"""

from __future__ import annotations

import numpy as np


def _quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dtype=np.float64,
    )


def _quat_matrix(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def euler_quaternion(angles_deg):
    """XYZ pitch/yaw/roll degrees -> quaternion (x, y, z, w), matching the
    reference Versor convention (Y yaw * X pitch * Z roll)."""
    pitch, yaw, roll = [np.radians(float(a)) * 0.5 for a in angles_deg]
    qx = np.array([np.sin(pitch), 0, 0, np.cos(pitch)])
    qy = np.array([0, np.sin(yaw), 0, np.cos(yaw)])
    qz = np.array([0, 0, np.sin(roll), np.cos(roll)])
    q = _quat_mul(_quat_mul(qy, qx), qz)
    return q / np.linalg.norm(q)


class Transform:
    """Affine TRS transform with uniform scale (reference entities only
    support uniform scale for instanced geometry correctness)."""

    def __init__(self, position=(0, 0, 0), rotation=(0, 0, 0, 1), scale=1.0):
        self.position = np.asarray(position, np.float64)
        self.rotation = np.asarray(rotation, np.float64)
        self.scale = float(scale)

    def matrix(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = _quat_matrix(self.rotation) * self.scale
        m[:3, 3] = self.position
        return m

    def compose(self, child: "Transform") -> np.ndarray:
        return self.matrix() @ child.matrix()


class Entity:
    """A node in the scene hierarchy."""

    def __init__(self, position=(0, 0, 0), rotation=(0, 0, 0, 1), scale=1.0, name=None):
        if len(np.shape(rotation)) and np.shape(rotation)[0] == 3:
            rotation = euler_quaternion(rotation)
        self.transform = Transform(position, rotation, scale)
        self.children: list[Entity] = []
        self.name = name

    # convenience accessors mirroring the reference API
    @property
    def position(self):
        return self.transform.position

    @position.setter
    def position(self, value):
        self.transform.position = np.asarray(value, np.float64)

    @property
    def rotation(self):
        return self.transform.rotation

    @rotation.setter
    def rotation(self, value):
        value = np.asarray(value, np.float64)
        if value.shape == (3,):
            value = euler_quaternion(value)
        self.transform.rotation = value

    @property
    def scale(self):
        return self.transform.scale

    @scale.setter
    def scale(self, value):
        self.transform.scale = float(value)

    def add(self, *children: "Entity") -> "Entity":
        self.children.extend(children)
        return self

    def walk(self, parent_matrix=None):
        """Yield (entity, world_matrix) over the subtree, depth first."""
        m = np.eye(4) if parent_matrix is None else parent_matrix
        world = m @ self.transform.matrix()
        yield self, world
        for child in self.children:
            yield from child.walk(world)

    def look_at(self, target):
        """Rotate so local +z faces `target` (reference Camera.LookAt,
        Scenic/Cameras/Camera.cs:41)."""
        forward = np.asarray(target, np.float64) - self.position
        forward = forward / np.linalg.norm(forward)
        up = np.array([0.0, 1.0, 0.0])
        if abs(np.dot(forward, up)) > 0.999:
            up = np.array([0.0, 0.0, 1.0])
        right = np.cross(up, forward)
        right /= np.linalg.norm(right)
        up = np.cross(forward, right)
        m = np.stack([right, up, forward], axis=1)
        # matrix -> quaternion
        tr = np.trace(m)
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            q = np.array(
                [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s, s / 4]
            )
        else:
            i = int(np.argmax(np.diag(m)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
            q = np.zeros(4)
            q[i] = s / 4
            q[j] = (m[j, i] + m[i, j]) / s
            q[k] = (m[k, i] + m[i, k]) / s
            q[3] = (m[k, j] - m[j, k]) / s
        self.transform.rotation = q / np.linalg.norm(q)
        return self


class EntityPack(Entity):
    """A root container of entities that can be instanced
    (reference Scenic/Hierarchies/EntityPack.cs)."""


class Scene(EntityPack):
    """The root pack of a renderable world (reference Scenic/Scene.cs)."""


class PackInstance(Entity):
    """Instances an EntityPack under a transform
    (reference Scenic/Hierarchies/PackInstance.cs). Instancing a Scene or
    creating recursive instance cycles is forbidden, as in the reference."""

    def __init__(self, pack: EntityPack, material_swatch=None, **kw):
        super().__init__(**kw)
        if isinstance(pack, Scene):
            raise ValueError("cannot instance a Scene")
        self.pack = pack
        self.material_swatch = material_swatch or {}
