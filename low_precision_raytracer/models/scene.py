"""Scene/resource manager (reference 2.14: `RDResource` + `RDScene`,
`rt/rtrt/memory.hpp:570-708`, `rt/rtrt/cuda.hpp:635-792`).

The reference's VBO/EBO/VAO indirection collapses into flat SoA HBM arrays +
per-mesh offset tables (SURVEY.md §7 "SoA everything"):

- :class:`SceneArrays` — load-time device state: vertices, indices, the
  per-triangle M-shift matrices (dtype + fp32 shadow, mirroring
  `RDResource::compute_m`, `rt/rtrt/memory.hpp:621-648`), packed BLAS,
  material table, texture atlas, skybox.
- :class:`FrameInput`  — per-frame device state: object constants
  (L2W/W2L pairs, `rt/rtrt/memory.hpp:279-301`), the TLAS (rebuilt on host
  every frame, `rt/rtrt/cuda.hpp:700`), lights, camera.

Both are registered JAX pytrees so the whole render step is one jitted
function over them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from low_precision_raytracer.config import Precision, get_precision
from low_precision_raytracer.math.hostmath import (
    cross_product_difference,
    inverse_3x3_dop,
    perspective,
)
from low_precision_raytracer.models.bvh import (
    PackedBLAS,
    build_blas,
    build_tlas,
    bvh_aabbs_for_dtype,
    pack_blas,
)
from low_precision_raytracer.models.hierarchy import (
    CameraObject,
    FlatScene,
    Object,
    build_flat_scene,
)
from low_precision_raytracer.models.materials import Material, pack_materials


def pytree_dataclass(cls=None, *, meta=()):
    """Register a frozen dataclass as a JAX pytree (meta fields are static)."""

    def wrap(c):
        c = dataclasses.dataclass(c, frozen=True)
        data = [f.name for f in dataclasses.fields(c) if f.name not in meta]
        jax.tree_util.register_dataclass(c, data_fields=data, meta_fields=list(meta))
        return c

    if cls is None:
        return wrap
    return wrap(cls)


@dataclass
class Mesh:
    """One triangle mesh (a reference "VAO"/primitive: positions + the
    RDVertex attribute set, `rt/rtrt/memory.hpp:27-41`)."""

    positions: np.ndarray  # (V, 3) f32
    indices: np.ndarray  # (T, 3) i32
    normals: np.ndarray | None = None
    tangents: np.ndarray | None = None
    colors: np.ndarray | None = None
    uv0: np.ndarray | None = None
    uv1: np.ndarray | None = None
    name: str = ""

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, np.int32).reshape(-1, 3)
        v = self.positions.shape[0]
        if self.normals is None:
            self.normals = np.tile(np.array([0, 1, 0], np.float32), (v, 1))
        if self.tangents is None:
            self.tangents = np.tile(np.array([1, 0, 0], np.float32), (v, 1))
        if self.colors is None:
            self.colors = np.ones((v, 3), np.float32)
        if self.uv0 is None:
            self.uv0 = np.zeros((v, 2), np.float32)
        if self.uv1 is None:
            self.uv1 = np.zeros((v, 2), np.float32)
        for name in ("normals", "tangents", "colors"):
            setattr(self, name, np.asarray(getattr(self, name), np.float32).reshape(v, 3))
        for name in ("uv0", "uv1"):
            setattr(self, name, np.asarray(getattr(self, name), np.float32).reshape(v, 2))

    @property
    def aabb(self):
        return self.positions.min(axis=0), self.positions.max(axis=0)

    @property
    def n_triangles(self) -> int:
        return self.indices.shape[0]


@dataclass
class Skybox:
    """Equirectangular IBL skybox (`RDSkybox`, `rt/rtrt/memory.hpp:671-692`)."""

    data: np.ndarray  # (H, W, 3) f32 linear HDR
    delta_x: float = 0.0
    delta_y: float = 0.0
    exposure: float = 1.0


@dataclass
class SceneObject:
    """Convenience flat description when no hierarchy is needed."""

    mesh_id: int
    material_id: int = 0
    transform: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))


@dataclass
class HostScene:
    """All load-time host state (the reference's RDResource + hierarchy)."""

    meshes: list = field(default_factory=list)
    materials: list = field(default_factory=list)
    textures: list = field(default_factory=list)  # list[np.ndarray (H,W,4) u8] + srgb flags
    texture_srgb: list = field(default_factory=list)
    root: Object = field(default_factory=Object)
    active_camera: CameraObject | None = None
    skybox: Skybox | None = None
    animated: bool = False

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1


@pytree_dataclass(meta=("leaf_size", "sky_valid"))
class SceneArrays:
    # vertices (SoA; dtype arrays carry the render precision, fp32 shadows
    # kept exactly where the reference keeps them)
    v_pos: jnp.ndarray
    v_pos_f32: jnp.ndarray
    v_normal: jnp.ndarray
    v_tangent: jnp.ndarray
    v_color: jnp.ndarray
    v_uv0: jnp.ndarray
    v_uv1: jnp.ndarray
    tri_idx: jnp.ndarray  # (T, 3) i32 global vertex indices
    # per-triangle M-shift data (`rt/rtrt/memory.hpp:581-584, 621-648`)
    tri_v2: jnp.ndarray  # (T, 3) dtype: third vertex position
    tri_v2_f32: jnp.ndarray
    tri_m: jnp.ndarray  # (T, 3, 3) dtype
    tri_m_f32: jnp.ndarray
    mesh_tri_offset: jnp.ndarray  # (n_meshes + 1,) i32
    # packed BLAS (global node ids; roots' parents are -1)
    blas_lo: jnp.ndarray
    blas_hi: jnp.ndarray
    blas_parent: jnp.ndarray
    blas_lc: jnp.ndarray
    blas_rc: jnp.ndarray
    blas_leaf_offset: jnp.ndarray
    blas_leaf_count: jnp.ndarray
    blas_prim: jnp.ndarray  # (P,) i32 global triangle ids
    blas_root: jnp.ndarray  # (n_meshes,) i32
    # material table
    mat_color: jnp.ndarray
    mat_emission: jnp.ndarray
    mat_metallic: jnp.ndarray
    mat_roughness: jnp.ndarray
    mat_double_sided: jnp.ndarray
    mat_tex_color: jnp.ndarray
    mat_uv_color: jnp.ndarray
    # loaded-but-unsampled, REFERENCE PARITY: the reference's loader fills
    # tex_emission/tex_mr into its material struct (`rt/rtrt/loader.cu:
    # 507-520`) but its shade kernel only ever samples tex_color
    # (`rt/rtrt/cuda.hpp:1852`; normal maps are a literal TODO at `:1882`)
    # — emission stays the constant factor.  Kept so the loader round-trips
    # full glTF materials; per-material scalars, negligible device weight.
    mat_tex_emission: jnp.ndarray
    mat_uv_emission: jnp.ndarray
    mat_tex_mr: jnp.ndarray
    mat_uv_mr: jnp.ndarray
    mat_channel_roughness: jnp.ndarray
    mat_channel_metallic: jnp.ndarray
    # texture atlas (flat; see ops/texture.py)
    tex_data: jnp.ndarray  # (total_px, 4) u8
    tex_offset: jnp.ndarray  # (K,) i32
    tex_width: jnp.ndarray
    tex_height: jnp.ndarray
    tex_srgb: jnp.ndarray
    # skybox
    sky_data: jnp.ndarray  # (h, w, 3) f32
    # quad-packed skybox texels in the render dtype: row (y, x) holds the
    # 2x2 bilinear footprint [(y,x), (y,x+1 wrap), (y+1 clamp, x),
    # (y+1 clamp, x+1 wrap)] flattened to 12 channels, so ONE flat take
    # fetches a whole bilinear sample
    sky_quad: jnp.ndarray  # (h*w, 12) dtype
    # packed per-triangle attribute rows for the one-hot-matmul interpolation
    # path (small scenes): (T, 48) = 3 vertices x [pos3 nrm3 tan3 col3 uv0.2
    # uv1.2]; a gather from a small table written as an (R, T) one-hot matmul
    tri_attr: jnp.ndarray = None
    # static meta
    leaf_size: int = 1
    sky_valid: bool = False

    @property
    def n_meshes(self) -> int:
        return self.blas_root.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.tri_idx.shape[0]


@pytree_dataclass(meta=("obj_layout", "n_lights"))
class FrameInput:
    # object constants (`CUDAObjectConstantData`)
    obj_l2w: jnp.ndarray  # (O, 4, 4) dtype
    obj_w2l: jnp.ndarray
    obj_l2w_f32: jnp.ndarray
    obj_w2l_f32: jnp.ndarray
    obj_mesh: jnp.ndarray  # (O,) i32
    obj_material: jnp.ndarray  # (O,) i32
    # TLAS (leaf size 1; prim -> object index)
    tlas_lo: jnp.ndarray
    tlas_hi: jnp.ndarray
    tlas_parent: jnp.ndarray
    tlas_lc: jnp.ndarray
    tlas_rc: jnp.ndarray
    tlas_leaf_offset: jnp.ndarray
    tlas_leaf_count: jnp.ndarray
    tlas_prim: jnp.ndarray
    # lights, padded to max_direct_lights
    light_type: jnp.ndarray  # (Lmax,) i32
    light_pos: jnp.ndarray  # (Lmax, 3) dtype
    light_dir: jnp.ndarray
    light_intensity: jnp.ndarray
    light_valid: jnp.ndarray  # (Lmax,) bool
    # camera
    cam_l2w: jnp.ndarray  # (4, 4) dtype (ray gen, `RDCamera::transform_L2W`)
    cam_w2c: jnp.ndarray  # (4, 4) f32 world-to-clip (reprojection)
    cam_fov_y: jnp.ndarray  # scalar dtype
    # f32 camera for reprojection-position reconstruction: hit positions
    # rebuilt as o32 + t * d32 reproject to sub-pixel accuracy even in
    # bf16 mode, where the render-dtype G-buffer position scatters the
    # footprint by +-10 px and forces the temporal gathers off their
    # shifted-select fast path (ops/reproject.py)
    cam_l2w_f32: jnp.ndarray  # (4, 4) f32
    cam_fov_y_f32: jnp.ndarray  # scalar f32
    # skybox dynamics
    sky_delta_x: jnp.ndarray
    sky_delta_y: jnp.ndarray
    sky_exposure: jnp.ndarray
    # dense-backend per-instance-triangle world-space test coefficients
    # (see ops/dense.py): rows n = A^T m (A = W2L linear part) and offsets
    # e = m.(b - v2) + n.c, recentered at the scene centre c
    dense_n: jnp.ndarray = None  # (TI, 3, 3) dtype
    dense_n_f32: jnp.ndarray = None  # (TI, 3, 3) f32
    dense_e: jnp.ndarray = None  # (TI, 3) f32
    dense_tri: jnp.ndarray = None  # (TI,) i32 global triangle id
    dense_obj: jnp.ndarray = None  # (TI,) i32 inscene object id
    dense_center: jnp.ndarray = None  # (3,) f32 scene centre
    # per-object world AABBs (fp32)
    obj_aabb_lo: jnp.ndarray = None  # (O, 3) f32
    obj_aabb_hi: jnp.ndarray = None  # (O, 3) f32
    # STATIC instance layout: ((mesh_id, tri_start, tri_end), ...) per object
    # — lets the all-pairs routes size themselves without reading traced values
    # (object list is static per scene)
    obj_layout: tuple = ()
    # STATIC active light count (<= max_direct_lights): shadow-ray batches
    # are sized to the scene's real light count instead of always tracing
    # MAX_DIRECT_LIGHT dead slots like the reference's fixed grid
    # (`rt/gui/imgui_window.cu:172-173`)
    n_lights: int = 0


def compute_m_matrices(positions_f32: np.ndarray, tri_idx: np.ndarray):
    """Per-triangle shear/inverse matrices in fp32 (`RDResource::compute_m`,
    `rt/rtrt/memory.hpp:621-648`).

    M1 columns are [v0-v2, v1-v2, cross_dop(v0-v2, v1-v2) - v2] (the
    reference subtracts v2 from the cross column; harmless for the
    barycentric solve since the z=0 plane is unchanged) and M = M1^-1 via the
    DifferenceOfProducts cofactor inverse.
    """
    v0 = positions_f32[tri_idx[:, 0]]
    v1 = positions_f32[tri_idx[:, 1]]
    v2 = positions_f32[tri_idx[:, 2]]
    e0 = v0 - v2
    e1 = v1 - v2
    col2 = cross_product_difference(e0, e1) - v2
    m1 = np.stack([e0, e1, col2], axis=-1)  # columns
    return inverse_3x3_dop(m1).astype(np.float32)


def build_scene_arrays(host: HostScene, prec: Precision | str, leaf_size: int = 4) -> SceneArrays:
    """Flatten host meshes/materials into device SoA arrays + packed BLAS."""
    prec = get_precision(prec)
    dt = prec.dtype
    np_dt = prec.np_dtype

    meshes = host.meshes
    assert meshes, "scene has no meshes"
    v_off = np.cumsum([0] + [m.positions.shape[0] for m in meshes])
    t_off = np.cumsum([0] + [m.n_triangles for m in meshes]).astype(np.int32)

    pos = np.concatenate([m.positions for m in meshes]).astype(np.float32)
    nrm = np.concatenate([m.normals for m in meshes]).astype(np.float32)
    tan = np.concatenate([m.tangents for m in meshes]).astype(np.float32)
    col = np.concatenate([m.colors for m in meshes]).astype(np.float32)
    uv0 = np.concatenate([m.uv0 for m in meshes]).astype(np.float32)
    uv1 = np.concatenate([m.uv1 for m in meshes]).astype(np.float32)
    tri_idx = np.concatenate(
        [m.indices + v_off[i] for i, m in enumerate(meshes)]
    ).astype(np.int32)

    # shared with flatten_frame's dense-coefficient build: one fp32
    # cofactor-inverse pass per scene, not one per entry point (seconds of
    # duplicated host precompute at multi-million-triangle scales)
    m_f32, v2_f32 = _host_m_cache(host)

    blas = pack_blas(
        [build_blas(m.positions, m.indices, leaf_size=leaf_size) for m in meshes],
        t_off[:-1],
    )
    blas_lo, blas_hi = bvh_aabbs_for_dtype(blas.aabb_lo, blas.aabb_hi, np_dt)

    mats = pack_materials(host.materials)

    # texture atlas: flat concatenation (RGBA u8); see ops/texture.py
    if host.textures:
        tex_offsets, tex_w, tex_h, flat = [], [], [], []
        off = 0
        for t in host.textures:
            t = np.asarray(t, np.uint8).reshape(t.shape[0], t.shape[1], -1)
            if t.shape[2] == 3:
                t = np.concatenate([t, np.full((*t.shape[:2], 1), 255, np.uint8)], axis=2)
            tex_offsets.append(off)
            tex_h.append(t.shape[0])
            tex_w.append(t.shape[1])
            flat.append(t.reshape(-1, 4))
            off += t.shape[0] * t.shape[1]
        tex_data = np.concatenate(flat)
        if tex_data.shape[0] == 1:
            # a real atlas totalling one pixel (single 1x1 solid-colour
            # texture) must stay distinguishable from the no-texture
            # placeholder row below — shade.py's static has-textures gate
            # is `tex_data.shape[0] > 1`
            tex_data = np.concatenate([tex_data, np.zeros((1, 4), np.uint8)])
        tex_offset = np.array(tex_offsets, np.int32)
        tex_width = np.array(tex_w, np.int32)
        tex_height = np.array(tex_h, np.int32)
        tex_srgb = np.array(host.texture_srgb, np.bool_)
    else:
        tex_data = np.zeros((1, 4), np.uint8)
        tex_offset = np.zeros((1,), np.int32)
        tex_width = np.ones((1,), np.int32)
        tex_height = np.ones((1,), np.int32)
        tex_srgb = np.zeros((1,), np.bool_)

    sky_valid = host.skybox is not None
    sky_data = (
        np.asarray(host.skybox.data, np.float32)
        if sky_valid
        else np.zeros((1, 1, 3), np.float32)
    )
    # quad-packed footprint rows (see SceneArrays.sky_quad): x wraps, y clamps
    _x1 = np.roll(sky_data, -1, axis=1)
    _y1 = np.concatenate([sky_data[1:], sky_data[-1:]], axis=0)
    _y1x1 = np.roll(_y1, -1, axis=1)
    sky_quad = np.concatenate([sky_data, _x1, _y1, _y1x1], axis=2).reshape(-1, 12)

    # packed per-triangle attribute rows (one-hot interpolation path)
    n_tris = tri_idx.shape[0]
    if n_tris <= 4096:
        per_vert = np.concatenate([pos, nrm, tan, col, uv0, uv1], axis=1)  # (V, 16)
        tri_attr = per_vert[tri_idx].reshape(n_tris, 48).astype(np.float32)
    else:
        tri_attr = None

    as_dt = lambda x: jnp.asarray(np.asarray(x, np.float32), dtype=dt)
    i32 = lambda x: jnp.asarray(x, jnp.int32)

    return SceneArrays(
        v_pos=as_dt(pos),
        v_pos_f32=jnp.asarray(pos),
        v_normal=as_dt(nrm),
        v_tangent=as_dt(tan),
        v_color=as_dt(col),
        v_uv0=as_dt(uv0),
        v_uv1=as_dt(uv1),
        tri_idx=i32(tri_idx),
        tri_v2=as_dt(v2_f32),
        tri_v2_f32=jnp.asarray(v2_f32),
        tri_m=as_dt(m_f32),
        tri_m_f32=jnp.asarray(m_f32),
        mesh_tri_offset=i32(t_off),
        blas_lo=jnp.asarray(np.asarray(blas_lo, np.float32), dtype=dt),
        blas_hi=jnp.asarray(np.asarray(blas_hi, np.float32), dtype=dt),
        blas_parent=i32(blas.parent),
        blas_lc=i32(blas.lc),
        blas_rc=i32(blas.rc),
        blas_leaf_offset=i32(blas.leaf_offset),
        blas_leaf_count=i32(blas.leaf_count),
        blas_prim=i32(blas.prim),
        blas_root=i32(blas.root),
        mat_color=as_dt(mats["color"]),
        mat_emission=as_dt(mats["emission"]),
        mat_metallic=as_dt(mats["metallic"]),
        mat_roughness=as_dt(mats["roughness"]),
        mat_double_sided=jnp.asarray(mats["double_sided"]),
        mat_tex_color=i32(mats["tex_color"]),
        mat_uv_color=i32(mats["uv_color"]),
        mat_tex_emission=i32(mats["tex_emission"]),
        mat_uv_emission=i32(mats["uv_emission"]),
        mat_tex_mr=i32(mats["tex_mr"]),
        mat_uv_mr=i32(mats["uv_mr"]),
        mat_channel_roughness=i32(mats["channel_roughness"]),
        mat_channel_metallic=i32(mats["channel_metallic"]),
        tex_data=jnp.asarray(tex_data),
        tex_offset=i32(tex_offset),
        tex_width=i32(tex_width),
        tex_height=i32(tex_height),
        tex_srgb=jnp.asarray(tex_srgb),
        sky_data=jnp.asarray(sky_data),
        sky_quad=jnp.asarray(sky_quad, dtype=dt),
        tri_attr=(as_dt(tri_attr) if tri_attr is not None else None),
        leaf_size=int(leaf_size),
        sky_valid=bool(sky_valid),
    )


def flatten_frame(
    host: HostScene,
    prec: Precision | str,
    time: float = 0.0,
    max_direct_lights: int = 4,
    width: int | None = None,
    height: int | None = None,
) -> FrameInput:
    """Per-frame host flatten + TLAS rebuild -> device FrameInput.

    Mirrors `Scene::build_rendering_scene` + `get_render_input`'s TLAS update
    (`rt/rtrt/cuda.hpp:662-710`).
    """
    prec = get_precision(prec)
    if host.animated or time != 0.0:
        host.root.apply_animation(time)
    flat = build_flat_scene(host.root, host.active_camera)
    return frame_input_from_flat(flat, host, prec, max_direct_lights, width, height)


def frame_input_from_flat(
    flat: FlatScene,
    host: HostScene,
    prec: Precision,
    max_direct_lights: int = 4,
    width: int | None = None,
    height: int | None = None,
) -> FrameInput:
    dt = prec.dtype
    np_dt = prec.np_dtype

    # per-frame TLAS rebuild (`rt/rtrt/cuda.hpp:700`), byte-keyed cache:
    # static frames (camera-only motion) reuse the previous tree
    tkey = (flat.obj_aabb_lo.tobytes(), flat.obj_aabb_hi.tobytes())
    tcache = getattr(host, "_tlas_cache", None)
    if tcache is not None and tcache[0] == tkey:
        tlas = tcache[1]
    else:
        tlas = build_tlas(flat.obj_aabb_lo, flat.obj_aabb_hi)
        host._tlas_cache = (tkey, tlas)
    tlas_lo, tlas_hi = bvh_aabbs_for_dtype(tlas.aabb_lo, tlas.aabb_hi, np_dt)

    n_l = flat.light_type.shape[0]
    lmax = max_direct_lights
    lt = np.zeros(lmax, np.int32)
    lp = np.zeros((lmax, 3), np.float32)
    ld = np.tile(np.array([0, 0, -1], np.float32), (lmax, 1))
    li = np.zeros((lmax, 3), np.float32)
    lv = np.zeros(lmax, np.bool_)
    k = min(n_l, lmax)
    lt[:k] = flat.light_type[:k]
    lp[:k] = flat.light_pos[:k]
    ld[:k] = flat.light_dir[:k]
    li[:k] = flat.light_intensity[:k]
    lv[:k] = True

    # world-to-clip for reprojection (`rt/gui/imgui_window.cu:287-293`)
    w = width if width is not None else 1
    h = height if height is not None else 1
    v2c = perspective(flat.cam_fov_y, w, h, flat.cam_z_near, flat.cam_z_far)
    w2c = (v2c @ flat.cam_w2v).astype(np.float32)

    sky = host.skybox

    t_off = np.cumsum([0] + [m.n_triangles for m in host.meshes])
    obj_layout = tuple(
        (int(m), int(t_off[m]), int(t_off[m + 1])) for m in flat.obj_mesh.tolist()
    )

    dense = _dense_coefficients(host, flat, t_off, prec)

    as_dt = lambda x: jnp.asarray(np.asarray(x, np.float32), dtype=dt)
    i32 = lambda x: jnp.asarray(x, jnp.int32)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))

    return FrameInput(
        obj_l2w=as_dt(flat.obj_l2w),
        obj_w2l=as_dt(flat.obj_w2l),
        obj_l2w_f32=f32(flat.obj_l2w),
        obj_w2l_f32=f32(flat.obj_w2l),
        obj_mesh=i32(flat.obj_mesh),
        obj_material=i32(flat.obj_material),
        obj_aabb_lo=f32(flat.obj_aabb_lo),
        obj_aabb_hi=f32(flat.obj_aabb_hi),
        tlas_lo=jnp.asarray(np.asarray(tlas_lo, np.float32), dtype=dt),
        tlas_hi=jnp.asarray(np.asarray(tlas_hi, np.float32), dtype=dt),
        tlas_parent=i32(tlas.parent),
        tlas_lc=i32(tlas.lc),
        tlas_rc=i32(tlas.rc),
        tlas_leaf_offset=i32(tlas.leaf_offset),
        tlas_leaf_count=i32(tlas.leaf_count),
        tlas_prim=i32(tlas.prim),
        light_type=i32(lt),
        light_pos=as_dt(lp),
        light_dir=as_dt(ld),
        light_intensity=as_dt(li),
        light_valid=jnp.asarray(lv),
        cam_l2w=as_dt(flat.cam_l2w),
        cam_w2c=f32(w2c),
        cam_fov_y=jnp.asarray(flat.cam_fov_y, dtype=dt),
        cam_l2w_f32=f32(flat.cam_l2w),
        cam_fov_y_f32=jnp.asarray(flat.cam_fov_y, jnp.float32),
        sky_delta_x=f32(sky.delta_x if sky else 0.0),
        sky_delta_y=f32(sky.delta_y if sky else 0.0),
        sky_exposure=f32(sky.exposure if sky else 1.0),
        obj_layout=obj_layout,
        n_lights=int(k),
        **dense,
    )


# the all-pairs routes (ops/dense.py, ops/dense_triton.py) take scenes up
# to these sizes (ops/trace.py:resolve_impl); the coefficient table is only
# built and uploaded for them
DENSE_MAX_TRIS = 8192
DENSE_MAX_OBJECTS = 64


def _host_m_cache(host: HostScene):
    """Per-HostScene cache of the fp32 M matrices and v2 vertices
    (frame-independent).

    Keyed on the identity of every mesh's position/index array (replacing a
    mesh or its arrays re-keys), and the cached arrays are FROZEN
    (writeable=False) so an in-place vertex edit raises instead of silently
    serving stale M matrices — hashing the geometry bytes per frame would
    cost more than the flatten it protects."""
    key = tuple((id(m.positions), id(m.indices)) for m in host.meshes)
    cache = getattr(host, "_m_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1], cache[2]
    for m in host.meshes:
        for a in (m.positions, m.indices):
            try:
                a.flags.writeable = False
            except ValueError:
                pass  # non-owning view; identity keying still covers swaps
    v_off = np.cumsum([0] + [m.positions.shape[0] for m in host.meshes])
    pos = np.concatenate([m.positions for m in host.meshes]).astype(np.float32)
    tri_idx = np.concatenate(
        [m.indices + v_off[i] for i, m in enumerate(host.meshes)]
    ).astype(np.int32)
    m_f32 = compute_m_matrices(pos, tri_idx)
    v2_f32 = pos[tri_idx[:, 2]]
    host._m_cache = (key, m_f32, v2_f32)
    return m_f32, v2_f32


def _dense_coefficients(host: HostScene, flat: FlatScene, t_off, prec: Precision):
    """World-space per-instance-triangle test coefficients for the all-pairs
    routes (ops/dense.py, ops/dense_triton.py): with local test (m @ (A o + b - v2)) and W2L
    linear part A, the world-ray form is n.o + e with rows n = m @ A and
    offsets e = m.(b - v2) (+ n.c recentering).  Computed on the host in
    float64 -> fp32 (the TLAS-rebuild analogue for the dense path).

    Per-frame cost is bounded by two host caches keyed on transform BYTES
    (exact, no tolerance):
    - whole-frame: if no instance transform changed (the interactive
      camera-only case — world-space coefficients are camera-independent),
      the previous frame's device-resident table dict is returned as-is,
      skipping both the rebuild and the re-upload;
    - per-object blocks: under animation only MOVED objects recompute their
      (n, e_base) block; the recenter term n.c is re-applied
      vectorized over the concatenated table (center moves with the scene
      AABB).  Generational eviction: blocks not referenced by the current
      frame are dropped.
    """
    n_obj = flat.obj_mesh.shape[0]
    ti = int(np.sum(t_off[flat.obj_mesh + 1] - t_off[flat.obj_mesh]))
    none = dict(
        dense_n=None, dense_n_f32=None, dense_e=None,
        dense_tri=None, dense_obj=None, dense_center=None,
    )
    if ti == 0 or ti > DENSE_MAX_TRIS or n_obj > DENSE_MAX_OBJECTS:
        return none

    cache = getattr(host, "_dense_cache", None)
    if cache is None or cache.get("n_tris") != ti:
        cache = {"blocks": {}, "key": None, "out": None, "n_tris": ti}
        host._dense_cache = cache
    frame_key = (
        prec.name,
        flat.obj_mesh.tobytes(),
        flat.obj_w2l.tobytes(),
        flat.obj_l2w.tobytes(),
    )
    if cache["key"] == frame_key:
        return cache["out"]

    m_f32, v2_f32 = _host_m_cache(host)
    center = (
        (flat.obj_aabb_lo.min(axis=0) + flat.obj_aabb_hi.max(axis=0)) / 2
    ).astype(np.float64)

    blocks = cache["blocks"]
    new_blocks = {}
    ns, es, tris, objs = [], [], [], []
    for o in range(n_obj):
        mesh = int(flat.obj_mesh[o])
        t0, t1 = int(t_off[mesh]), int(t_off[mesh + 1])
        if t0 == t1:
            continue
        bkey = (mesh, flat.obj_w2l[o].tobytes(), flat.obj_l2w[o].tobytes())
        blk = new_blocks.get(bkey) or blocks.get(bkey)
        if blk is None:
            w2l = flat.obj_w2l[o].astype(np.float64)
            A = w2l[:3, :3]
            b = w2l[:3, 3]
            m = m_f32[t0:t1].astype(np.float64)  # (T, 3, 3) rows
            v2 = v2_f32[t0:t1].astype(np.float64)
            n = m @ A  # rows transformed: n[t, r] = A^T m[t, r]
            # e_base stays f64: it cancels against n.c below (recentering
            # exists precisely because the raw offsets can be large)
            e_base = np.einsum("trk,tk->tr", m, b[None, :] - v2)
            blk = (n.astype(np.float32), e_base)
        new_blocks[bkey] = blk
        ns.append(blk[0])
        es.append(blk[1])
        tris.append(np.arange(t0, t1, dtype=np.int32))
        objs.append(np.full(t1 - t0, o, np.int32))
    cache["blocks"] = new_blocks

    n_all = np.concatenate(ns)  # f32
    e_all = (np.concatenate(es) + n_all.astype(np.float64) @ center).astype(
        np.float32
    )
    tri_all = np.concatenate(tris)
    obj_all = np.concatenate(objs)
    dt = prec.dtype
    out = dict(
        dense_n=jnp.asarray(n_all, dtype=dt),
        dense_n_f32=jnp.asarray(n_all),
        dense_e=jnp.asarray(e_all),
        dense_tri=jnp.asarray(tri_all),
        dense_obj=jnp.asarray(obj_all),
        dense_center=jnp.asarray(center.astype(np.float32)),
    )
    cache["key"] = frame_key
    cache["out"] = out
    return out
