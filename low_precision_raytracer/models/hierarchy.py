"""Scene hierarchy + animation (reference L3: `rt/rtrt/hierarchy.hpp`).

Host-side Python object tree with TRS + quaternion transforms, keyframe
animation samplers and per-frame flattening to render arrays.  Animation
sampling is tiny and stays numpy (SURVEY.md 2.15).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from low_precision_raytracer.math.hostmath import (
    invert_rigid,
    look_at,
    quaternion_to_matrix,
    trs_matrix,
)

# RDLight light types (`rt/rtrt/memory.hpp:44`)
LIGHT_SPOT = 0
LIGHT_POINT = 1
LIGHT_DIRECTIONAL = 2


@dataclass
class Sampler:
    """Keyframe sampler with fmod looping (`rt/rtrt/hierarchy.hpp:81-113`).

    Quaternion channels use *component lerp, not slerp* — kept deliberately
    for behavioural parity (`rt/rtrt/hierarchy.hpp:112`, SURVEY.md non-goals).
    """

    times: np.ndarray | None = None  # (K,)
    values: np.ndarray | None = None  # (K, D)
    step: bool = False  # STEP interpolation: hold values[i] over segment i

    def sample(self, time: float, default):
        if self.times is None or len(self.times) == 0:
            return np.asarray(default, np.float32)
        if len(self.times) == 1:
            return np.asarray(self.values[0], np.float32)
        max_time = float(self.times[-1])
        if time >= max_time:
            time = float(np.fmod(time, max_time))
        # first segment i with times[i+1] >= time
        i = int(np.searchsorted(self.times[1:], time, side="left"))
        i = min(i, len(self.times) - 2)
        t0, t1 = float(self.times[i]), float(self.times[i + 1])
        if self.step:
            return np.asarray(self.values[i], np.float32)
        # duplicated keyframe times (step-like exports) make a zero-length
        # segment: take its end value instead of dividing by zero
        u = (time - t0) / (t1 - t0) if t1 > t0 else 1.0
        return ((1.0 - u) * self.values[i] + u * self.values[i + 1]).astype(np.float32)


@dataclass
class Animation:
    translation: Sampler = field(default_factory=Sampler)
    scale: Sampler = field(default_factory=Sampler)
    rotation: Sampler = field(default_factory=Sampler)  # quats (x, y, z, w)


@dataclass
class Object:
    """Hierarchy node (`hierarchy::Object`, `rt/rtrt/hierarchy.hpp:122-219`)."""

    name: str = ""
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32)
    )  # quat (x, y, z, w)
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    animation: Animation = field(default_factory=Animation)
    children: list = field(default_factory=list)
    parent: "Object | None" = None

    def add(self, child: "Object") -> "Object":
        child.parent = self
        self.children.append(child)
        return child

    def apply_animation(self, time: float) -> None:
        """Recursive TRS animation update (`rt/rtrt/hierarchy.hpp:135-143`)."""
        self.translation = self.animation.translation.sample(time, self.translation)
        self.scale = self.animation.scale.sample(time, self.scale)
        q = self.animation.rotation.sample(time, self.rotation)
        self.rotation = np.asarray(q, np.float32)
        for child in self.children:
            child.apply_animation(time)

    def transform_matrix(self) -> np.ndarray:
        """T * R * S (`rt/rtrt/hierarchy.hpp:145-150`).  The rotation is
        normalized before conversion — the reference routes through
        glm angle/axis which has the same effect on lerped quats.

        Cached on exact TRS bytes: un-animated nodes pay one compute total,
        not one per frame (the host flatten is per-frame, §5.8 TLAS-rebuild
        analogue).  The returned matrix is shared — callers must not mutate.
        """
        t = np.asarray(self.translation, np.float32)
        q = np.asarray(self.rotation, np.float32)
        s = np.asarray(self.scale, np.float32)
        key = (t.tobytes(), q.tobytes(), s.tobytes())
        hit = self.__dict__.get("_tm_cache")
        if hit is not None and hit[0] == key:
            return hit[1]
        n = np.linalg.norm(q)
        if n > 0:
            q = q / n
        m = trs_matrix(t, q, s)
        self._tm_cache = (key, m)
        return m

    def local_to_world(self) -> np.ndarray:
        m = self.transform_matrix()
        node = self.parent
        while node is not None:
            m = node.transform_matrix() @ m
            node = node.parent
        return m

    def insert_parent(self) -> "Object":
        """Re-parent through a fresh node carrying this node's TRS (used for
        the free camera, `rt/rtrt/hierarchy.hpp:170-193`)."""
        holder = Object(name=self.name + "_holder")
        holder.translation = self.translation
        holder.rotation = self.rotation
        holder.scale = self.scale
        self.translation = np.zeros(3, np.float32)
        self.rotation = np.array([0, 0, 0, 1], np.float32)
        self.scale = np.ones(3, np.float32)
        old_parent = self.parent
        holder.children = [self]
        self.parent = holder
        holder.parent = old_parent
        if old_parent is not None:
            old_parent.children = [
                holder if c is self else c for c in old_parent.children
            ]
        return holder

    def search(self, name: str) -> "Object | None":
        if self.name == name:
            return self
        for child in self.children:
            found = child.search(name)
            if found is not None:
                return found
        return None

    def search_type(self, cls) -> "Object | None":
        if isinstance(self, cls):
            return self
        for child in self.children:
            found = child.search_type(cls)
            if found is not None:
                return found
        return None

    def walk(self):
        yield self
        for child in self.children:
            yield from child.walk()


@dataclass
class MeshObject(Object):
    """A node instancing a mesh (`hierarchy::MeshObject`)."""

    mesh_id: int = 0  # the reference's `objectid` = VAO index
    material_id: int = 0
    aabb_lo: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    aabb_hi: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))

    def world_aabb(self, transform: np.ndarray):
        """Transform the 8 box corners (`MeshObject::get_aabb`,
        `rt/rtrt/hierarchy.hpp:43-61`)."""
        bounds = np.stack([self.aabb_lo, self.aabb_hi])
        corners = np.array(
            [
                [bounds[(i >> 0) & 1][0], bounds[(i >> 1) & 1][1], bounds[(i >> 2) & 1][2]]
                for i in range(8)
            ],
            np.float32,
        )
        h = np.concatenate([corners, np.ones((8, 1), np.float32)], axis=1)
        w = (transform @ h.T).T
        w = w[:, :3] / w[:, 3:4]
        return w.min(axis=0), w.max(axis=0)


@dataclass
class CameraObject(Object):
    """Perspective camera node (`hierarchy::Camera` + `RDCamera`,
    `rt/rtrt/memory.hpp:382-397`)."""

    fov_y: float = np.pi / 2
    aspect_ratio: float = 1.0
    z_near: float = 0.1
    z_far: float = 100.0

    def world_to_view(self, transform: np.ndarray) -> np.ndarray:
        """lookAt through the node transform (`rt/rtrt/hierarchy.hpp:67-72`)."""

        def apply(p, w):
            h = transform @ np.array([*p, w], np.float32)
            return h[:3] / (h[3] if w == 1.0 else 1.0)

        eye = apply((0, 0, 0), 1.0)
        center = apply((0, 0, -1), 1.0)
        up = apply((0, 1, 0), 0.0)
        return look_at(eye, center, up)


@dataclass
class LightObject(Object):
    """Punctual light node (`hierarchy::Light` + `RDLight`)."""

    light_type: int = LIGHT_POINT
    intensity: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    inner_cone_angle: float = 0.0
    outer_cone_angle: float = np.pi / 4
    maximum_distance: float = 1e5


@dataclass
class FlatScene:
    """Per-frame flattened scene (the reference's `RDScene`,
    `rt/rtrt/memory.hpp:694-708`): numpy host arrays ready for device upload."""

    obj_l2w: np.ndarray  # (O, 4, 4) f32
    obj_w2l: np.ndarray  # (O, 4, 4) f32
    obj_mesh: np.ndarray  # (O,) i32  (`objectid`)
    obj_material: np.ndarray  # (O,) i32
    obj_aabb_lo: np.ndarray  # (O, 3) f32 world space
    obj_aabb_hi: np.ndarray  # (O, 3) f32
    light_type: np.ndarray  # (L,) i32
    light_pos: np.ndarray  # (L, 3) f32
    light_dir: np.ndarray  # (L, 3) f32
    light_intensity: np.ndarray  # (L, 3) f32
    cam_l2w: np.ndarray  # (4, 4) f32
    cam_w2v: np.ndarray  # (4, 4) f32
    cam_fov_y: float = np.pi / 2
    cam_z_near: float = 0.1
    cam_z_far: float = 100.0


def build_flat_scene(root: Object, active_camera: CameraObject | None) -> FlatScene:
    """Flatten the hierarchy (`Scene::build_rendering_scene`,
    `rt/rtrt/hierarchy.hpp:222-290`)."""
    objs, lights = [], []
    cam = {}

    def rec(node: Object, transform: np.ndarray):
        new_t = transform @ node.transform_matrix()
        if isinstance(node, MeshObject):
            # world-transform-keyed cache: static subtrees skip the 8-corner
            # AABB transform + inverse every frame (exact byte key)
            tb = new_t.tobytes()
            hit = node.__dict__.get("_flat_cache")
            if hit is not None and hit[0] == tb:
                _, w2l, lo, hi = hit
            else:
                lo, hi = node.world_aabb(new_t)
                w2l = invert_rigid(new_t)
                node._flat_cache = (tb, w2l, lo, hi)
            objs.append((new_t, w2l, node.mesh_id, node.material_id, lo, hi))
        elif isinstance(node, LightObject):
            d = new_t @ np.array([0, 0, -1, 0], np.float32)
            d = d[:3] / np.linalg.norm(d[:3])
            lights.append((node.light_type, new_t[:3, 3].copy(), d, node.intensity))
        elif isinstance(node, CameraObject) and node is active_camera:
            cam["l2w"] = new_t
            cam["w2v"] = node.world_to_view(new_t)
        for child in node.children:
            rec(child, new_t)

    rec(root, np.eye(4, dtype=np.float32))
    if active_camera is None:
        raise ValueError("no active camera")
    if "l2w" not in cam:  # active camera not in the tree: use its own L2W
        m = active_camera.local_to_world()
        cam["l2w"] = m
        cam["w2v"] = active_camera.world_to_view(m)
    if not objs:
        raise ValueError("scene contains no mesh objects")

    return FlatScene(
        obj_l2w=np.stack([o[0] for o in objs]).astype(np.float32),
        obj_w2l=np.stack([o[1] for o in objs]).astype(np.float32),
        obj_mesh=np.array([o[2] for o in objs], np.int32),
        obj_material=np.array([o[3] for o in objs], np.int32),
        obj_aabb_lo=np.stack([o[4] for o in objs]).astype(np.float32),
        obj_aabb_hi=np.stack([o[5] for o in objs]).astype(np.float32),
        light_type=np.array([l[0] for l in lights], np.int32).reshape(-1),
        light_pos=np.stack([l[1] for l in lights]).astype(np.float32)
        if lights
        else np.zeros((0, 3), np.float32),
        light_dir=np.stack([l[2] for l in lights]).astype(np.float32)
        if lights
        else np.zeros((0, 3), np.float32),
        light_intensity=np.stack([l[3] for l in lights]).astype(np.float32)
        if lights
        else np.zeros((0, 3), np.float32),
        cam_l2w=cam["l2w"].astype(np.float32),
        cam_w2v=cam["w2v"].astype(np.float32),
        cam_fov_y=float(active_camera.fov_y),
        cam_z_near=float(active_camera.z_near),
        cam_z_far=float(active_camera.z_far),
    )
