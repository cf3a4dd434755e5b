"""Procedural test scenes (no glTF needed): unit meshes, the Cornell box
(BASELINE config 2) and simple single-mesh scenes (BASELINE config 1)."""

from __future__ import annotations

import numpy as np

from low_precision_raytracer.models.hierarchy import (
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    CameraObject,
    LightObject,
    MeshObject,
    Object,
)
from low_precision_raytracer.models.materials import Material
from low_precision_raytracer.models.scene import HostScene, Mesh


def quad_mesh(size=1.0):
    """Unit quad in the XY plane facing +Z."""
    s = size / 2
    pos = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    nrm = np.tile([0, 0, 1], (4, 1)).astype(np.float32)
    tan = np.tile([1, 0, 0], (4, 1)).astype(np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return Mesh(pos, idx, normals=nrm, tangents=tan, uv0=uv, name="quad")


def cube_mesh(size=1.0):
    """Axis-aligned cube with outward normals, 12 triangles."""
    s = size / 2
    faces = []
    # (axis, sign): +x, -x, +y, -y, +z, -z
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            u = np.zeros(3, np.float32)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            c = n * s
            corners = [c - u * s - v * s, c + u * s - v * s, c + u * s + v * s, c - u * s + v * s]
            faces.append((np.stack(corners), n, u))
    pos, nrm, tan, idx = [], [], [], []
    for i, (corners, n, u) in enumerate(faces):
        base = 4 * i
        pos.append(corners)
        nrm.append(np.tile(n, (4, 1)))
        tan.append(np.tile(u, (4, 1)))
        idx.append([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return Mesh(
        np.concatenate(pos).astype(np.float32),
        np.concatenate(idx).astype(np.int32),
        normals=np.concatenate(nrm).astype(np.float32),
        tangents=np.concatenate(tan).astype(np.float32),
        name="cube",
    )


def icosphere_mesh(subdiv=2, radius=1.0):
    """Icosphere by midpoint subdivision."""
    t = (1 + 5**0.5) / 2
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float32,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int32,
    )
    for _ in range(subdiv):
        cache: dict = {}
        vlist = [v for v in verts]

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = vlist[a] + vlist[b]
                m = m / np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m.astype(np.float32))
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.stack(vlist)
        faces = np.array(new_faces, np.int32)
    verts = verts * radius
    nrm = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    tan = np.cross(np.tile([0, 1, 0], (len(verts), 1)), nrm)
    bad = np.linalg.norm(tan, axis=1) < 1e-6
    tan[bad] = [1, 0, 0]
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    return Mesh(verts, faces, normals=nrm, tangents=tan.astype(np.float32), name="icosphere")


def animated_cornell_scene():
    """BASELINE config 4: Cornell box with TRS animations (orbiting tall box,
    bobbing light) driving temporal reprojection + SVGF."""
    scene = cornell_box_scene()
    from low_precision_raytracer.models.hierarchy import Sampler

    tall = scene.root.search("tall")
    times = np.array([0.0, 1.0, 2.0, 3.0, 4.0], np.float32)
    quarter = np.array(
        [0, np.sin(np.pi / 4), 0, np.cos(np.pi / 4)], np.float32
    )
    half = np.array([0, 1, 0, 0], np.float32)
    three_q = np.array([0, np.sin(3 * np.pi / 4), 0, np.cos(3 * np.pi / 4)], np.float32)
    ident = np.array([0, 0, 0, 1], np.float32)
    # the loop closes on -ident (same rotation as ident): three_q . ident is
    # NEGATIVE, and the component lerp (deliberately slerp-free, reference
    # parity) would otherwise cross near-zero quaternions over t in (3, 4) —
    # a non-uniform reverse spin in the quarter of every loop that this
    # scene's temporal benchmarks exercise
    tall.animation.rotation = Sampler(
        times=times, values=np.stack([ident, quarter, half, three_q, -ident])
    )
    tall.animation.translation = Sampler(
        times=np.array([0.0, 2.0, 4.0], np.float32),
        values=np.array([[-0.35, -0.4, -0.35], [-0.1, -0.4, -0.35], [-0.35, -0.4, -0.35]], np.float32),
    )
    lamp = scene.root.search("lamp")
    lamp.animation.translation = Sampler(
        times=np.array([0.0, 1.0, 2.0], np.float32),
        values=np.array([[0, 0.85, 0], [0.3, 0.85, 0], [0, 0.85, 0]], np.float32),
    )
    scene.animated = True
    return scene


def sponza_like_scene(pillar_grid: int = 4, sphere_subdiv: int = 2, with_skybox: bool = True):
    """BASELINE config 5: a colonnade scene — pillars, floor, varied PBR
    materials, equirect HDR skybox IBL.  Triangle count scales with
    pillar_grid/sphere_subdiv: the (4, 2) default is 5,314 instance-tris /
    33 objects ("colonnade-5k"); (8, 3) is 82,690 instance-tris / 129
    objects ("colonnade-83k", the large-scene benchmark config — real
    Sponza is ~260k, so only the (8,3)+ variants deserve the comparison)."""
    from low_precision_raytracer.models.scene import Skybox

    scene = HostScene()
    floor = scene.add_mesh(quad_mesh(2.0))
    pillar = scene.add_mesh(cube_mesh(1.0))
    ball = scene.add_mesh(icosphere_mesh(sphere_subdiv))

    ground = scene.add_material(Material(color=np.array([0.6, 0.6, 0.6], np.float32), roughness=0.8))
    stone = scene.add_material(Material(color=np.array([0.75, 0.7, 0.6], np.float32), roughness=0.6))
    gold = scene.add_material(
        Material(color=np.array([1.0, 0.77, 0.34], np.float32), metallic=1.0, roughness=0.3)
    )
    glaze = scene.add_material(
        Material(color=np.array([0.2, 0.4, 0.8], np.float32), metallic=0.0, roughness=0.05)
    )

    scene.root = Object(name="root")
    r = scene.root
    sq2 = np.float32(np.sqrt(0.5))
    size = pillar_grid * 3.0
    r.add(_mesh_node(scene, floor, ground, "floor", t=[0, 0, 0], r=[-sq2, 0, 0, sq2],
                     s=[size, size, 1]))
    mats = [stone, gold, glaze]
    k = 0
    for i in range(pillar_grid):
        for j in range(pillar_grid):
            x = (i - (pillar_grid - 1) / 2) * 4.0
            z = (j - (pillar_grid - 1) / 2) * 4.0
            r.add(_mesh_node(scene, pillar, stone, f"pillar{i}_{j}",
                             t=[x, 1.5, z], s=[0.6, 3.0, 0.6]))
            r.add(_mesh_node(scene, ball, mats[k % 3], f"ball{i}_{j}",
                             t=[x, 3.4, z], s=[0.5, 0.5, 0.5]))
            k += 1

    sun = LightObject(name="sun", light_type=LIGHT_DIRECTIONAL,
                      intensity=np.array([3.0, 2.9, 2.6], np.float32))
    deg = np.pi / 180
    sun.rotation = np.array([np.sin(-60 * deg / 2), 0, 0, np.cos(-60 * deg / 2)], np.float32)
    r.add(sun)
    fill = LightObject(name="fill", light_type=LIGHT_POINT,
                       intensity=np.array([40.0, 42.0, 50.0], np.float32))
    fill.translation = np.array([0.0, 5.0, 0.0], np.float32)
    r.add(fill)

    cam = CameraObject(name="cam", fov_y=np.pi / 3)
    cam.translation = np.array([0.0, 2.2, pillar_grid * 2.2], np.float32)
    r.add(cam)
    scene.active_camera = cam

    if with_skybox:
        scene.skybox = Skybox(data=procedural_sky(64, 128), exposure=1.0)
    return scene


def procedural_sky(height: int = 64, width: int = 128):
    """Simple analytic HDR sky panorama (blue gradient + sun disc) — an
    egress-free stand-in for an equirectangular .hdr file."""
    v = np.linspace(0, 1, height, dtype=np.float32)[:, None]  # 0=top of image
    u = np.linspace(0, 1, width, dtype=np.float32)[None, :]
    elev = (1 - v) * np.pi - np.pi / 2  # image top = zenith (see uv mapping)
    horizon = np.exp(-np.abs(np.sin(elev)) * 2.5)
    zenith = np.clip(np.sin(elev), 0, 1)
    r = 0.18 + 0.5 * horizon
    g = 0.28 + 0.5 * horizon
    b = 0.55 + 0.35 * horizon + 0.25 * zenith
    sky = np.stack(np.broadcast_arrays(r * np.ones_like(u), g * np.ones_like(u), b + 0 * u), axis=-1)
    # sun disc
    su, sv = 0.25, 0.3
    d2 = ((u - su) ** 2 + (v - sv) ** 2)
    sun = np.exp(-d2 / 0.0004)[..., None] * np.array([60.0, 55.0, 45.0], np.float32)
    return (sky + sun).astype(np.float32)


def _mesh_node(scene: HostScene, mesh_id: int, material_id: int, name: str, t=None, r=None, s=None):
    mesh = scene.meshes[mesh_id]
    lo, hi = mesh.aabb
    node = MeshObject(
        name=name, mesh_id=mesh_id, material_id=material_id, aabb_lo=lo, aabb_hi=hi
    )
    if t is not None:
        node.translation = np.asarray(t, np.float32)
    if r is not None:
        node.rotation = np.asarray(r, np.float32)
    if s is not None:
        node.scale = np.asarray(s, np.float32)
    return node


def single_triangle_scene():
    """One triangle + directional light + camera: the smallest traceable scene."""
    scene = HostScene()
    tri = Mesh(
        np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
        np.array([[0, 1, 2]], np.int32),
        normals=np.tile([0, 0, 1], (3, 1)).astype(np.float32),
    )
    mid = scene.add_mesh(tri)
    mat = scene.add_material(Material(color=np.array([0.8, 0.2, 0.2], np.float32)))
    scene.root = Object(name="root")
    scene.root.add(_mesh_node(scene, mid, mat, "tri"))
    light = LightObject(name="sun", light_type=LIGHT_DIRECTIONAL, intensity=np.array([1.0, 1.0, 1.0], np.float32))
    light.rotation = np.array([0, 0, 0, 1], np.float32)
    scene.root.add(light)
    cam = CameraObject(name="cam", fov_y=np.pi / 3)
    cam.translation = np.array([0, 0, 3], np.float32)
    scene.root.add(cam)
    scene.active_camera = cam
    return scene


def single_mesh_scene(mesh: Mesh | None = None):
    """BASELINE config 1: single mesh, 1-bounce direct lighting."""
    scene = HostScene()
    mid = scene.add_mesh(mesh if mesh is not None else icosphere_mesh(2))
    mat = scene.add_material(
        Material(color=np.array([0.7, 0.7, 0.75], np.float32), metallic=0.0, roughness=0.4)
    )
    scene.root = Object(name="root")
    scene.root.add(_mesh_node(scene, mid, mat, "mesh"))
    key = LightObject(
        name="key", light_type=LIGHT_POINT, intensity=np.array([60.0, 60.0, 55.0], np.float32)
    )
    key.translation = np.array([2.0, 2.5, 2.0], np.float32)
    scene.root.add(key)
    cam = CameraObject(name="cam", fov_y=np.pi / 3)
    cam.translation = np.array([0, 0.4, 3.0], np.float32)
    scene.root.add(cam)
    scene.active_camera = cam
    return scene


def cornell_box_scene(light_intensity=30.0):
    """BASELINE config 2: the Cornell box (5 walls, 2 boxes, 1 point light)."""
    scene = HostScene()
    quad = scene.add_mesh(quad_mesh(2.0))
    box = scene.add_mesh(cube_mesh(1.0))

    white = scene.add_material(Material(color=np.array([0.73, 0.73, 0.73], np.float32)))
    red = scene.add_material(Material(color=np.array([0.65, 0.05, 0.05], np.float32)))
    green = scene.add_material(Material(color=np.array([0.12, 0.45, 0.15], np.float32)))
    metal = scene.add_material(
        Material(color=np.array([0.8, 0.85, 0.9], np.float32), metallic=1.0, roughness=0.15)
    )

    scene.root = Object(name="root")
    r = scene.root
    sq2 = np.float32(np.sqrt(0.5))
    ws = [1.05, 1.05, 1]  # overlap wall seams so corner rays cannot escape
    # floor (XY quad rotated to face +Y)
    r.add(_mesh_node(scene, quad, white, "floor", t=[0, -1, 0], r=[-sq2, 0, 0, sq2], s=ws))
    # ceiling faces -Y
    r.add(_mesh_node(scene, quad, white, "ceiling", t=[0, 1, 0], r=[sq2, 0, 0, sq2], s=ws))
    # back wall faces +Z
    r.add(_mesh_node(scene, quad, white, "back", t=[0, 0, -1], s=ws))
    # left wall (red) faces +X
    r.add(_mesh_node(scene, quad, red, "left", t=[-1, 0, 0], r=[0, sq2, 0, sq2], s=ws))
    # right wall (green) faces -X
    r.add(_mesh_node(scene, quad, green, "right", t=[1, 0, 0], r=[0, -sq2, 0, sq2], s=ws))
    # tall box
    deg = np.pi / 180
    q18 = np.array([0, np.sin(18 * deg / 2), 0, np.cos(18 * deg / 2)], np.float32)
    r.add(_mesh_node(scene, box, white, "tall", t=[-0.35, -0.4, -0.35], r=q18, s=[0.55, 1.2, 0.55]))
    # short metal box
    qm15 = np.array([0, np.sin(-15 * deg / 2), 0, np.cos(-15 * deg / 2)], np.float32)
    r.add(_mesh_node(scene, box, metal, "short", t=[0.4, -0.7, 0.35], r=qm15, s=[0.55, 0.6, 0.55]))

    light = LightObject(
        name="lamp",
        light_type=LIGHT_POINT,
        intensity=np.array([light_intensity] * 3, np.float32),
    )
    light.translation = np.array([0, 0.85, 0], np.float32)
    r.add(light)

    # narrow fov so the 2x2 back wall fills the frame from z=3.2; the small
    # x/y offset breaks exact pixel-center/triangle-edge alignment (rays down
    # the quad diagonals would otherwise thread the shared-edge seam)
    cam = CameraObject(name="cam", fov_y=0.47)
    cam.translation = np.array([0.0131, 0.0077, 3.2], np.float32)
    r.add(cam)
    scene.active_camera = cam
    return scene
