"""glTF 2.0 loader (reference 2.16: `rt/rtrt/loader.cu`, tinygltf-based).

Hand-rolled JSON/.glb parsing + numpy accessor decoding -> :class:`HostScene`.
Reproduces the reference's behaviours:

- triangles-only primitives (`rt/rtrt/loader.cu:310-315` throws otherwise);
- POSITION/NORMAL required; TANGENT synthesized perpendicular to the normal
  when missing (`:376-390`: (-b, a, 0) or (0, -c, b));
- TEXCOORD_0/1 default (0,0), COLOR_0 default (1,1,1,1) (`:393-416`);
- default material at id 0; primitive material ids offset by the current
  material count (multi-file append, `:774-776, 320`);
- baseColor/emissive textures sRGB, metallicRoughness/normal linear;
  channel mapping G=roughness, B=metallic (`:503-525`);
- lights via KHR_lights_punctual: point, directional, and **spot mapped to
  point** (`:552-619`); intensity = color * intensity, range -> max distance;
- cameras perspective-only (orthographic warns, `:583`);
- node TRS, or matrix decomposed to TRS (`:651-676`);
- animation channels translation/scale/rotation; other paths warn (`:727`).
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from low_precision_raytracer.models.hierarchy import (
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    Animation,
    CameraObject,
    LightObject,
    MeshObject,
    Object,
    Sampler,
)
from low_precision_raytracer.models.materials import NO_TEX, Material
from low_precision_raytracer.models.scene import HostScene, Mesh
from low_precision_raytracer.utils.log import warn

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}
_NORM_SCALE = {np.int8: 127.0, np.uint8: 255.0, np.int16: 32767.0, np.uint16: 65535.0}

MODE_TRIANGLES = 4


class GLTFError(Exception):
    pass


class _Model:
    """Parsed glTF JSON + resolved binary buffers."""

    def __init__(self, gltf: dict, buffers: list[bytes], base_dir: str):
        self.gltf = gltf
        self.buffers = buffers
        self.base_dir = base_dir

    def _view_data(self, view_index: int, byte_offset: int, count: int,
                   n: int, comp, stride_override: int | None = None) -> np.ndarray:
        """Strided, endian-safe read of `count` x `n` `comp` elements from a
        bufferView (the core of `load_data`, `rt/rtrt/loader.cu:90-190`)."""
        itemsize = np.dtype(comp).itemsize
        views = self.gltf["bufferViews"]
        if not 0 <= view_index < len(views):
            raise GLTFError(f"bufferView index {view_index} out of range")
        bv = views[view_index]
        buf = self.buffers[bv["buffer"]]
        offset = bv.get("byteOffset", 0) + byte_offset
        stride = stride_override or bv.get("byteStride", 0) or (n * itemsize)
        need = stride * (count - 1) + n * itemsize
        # validate against BOTH the view's declared extent and the backing
        # buffer (tinygltf validates this for the reference; a silent
        # short read would corrupt geometry)
        view_end = bv.get("byteOffset", 0) + bv.get("byteLength", len(buf))
        if count > 0 and (offset + need > len(buf) or offset + need > view_end):
            raise GLTFError(
                f"accessor read [{offset}, {offset + need}) exceeds "
                f"bufferView {view_index} (end {view_end}, buffer {len(buf)} B)"
            )
        raw = np.frombuffer(buf, dtype=np.uint8, count=max(need, 0), offset=offset)
        if stride == n * itemsize:
            return raw.view(np.dtype(comp).newbyteorder("<")).reshape(count, n)
        idx = (
            np.arange(count)[:, None] * stride
            + np.arange(n * itemsize)[None, :]
        )
        return (
            raw[idx]
            .copy()
            .view(np.dtype(comp).newbyteorder("<"))
            .reshape(count, n)
        )

    def accessor(self, index: int) -> np.ndarray:
        """Endian-safe accessor reader (`load_data`, `rt/rtrt/loader.cu:52-190`).
        -> (count, n_components) f32 (normalized when flagged) or integer array.

        Sparse accessors are applied per spec: base data (or zeros when the
        accessor has no bufferView) with `sparse.count` rows substituted from
        the values view at positions from the indices view — the behaviour
        tinygltf gives the reference for free by pre-decoding buffers."""
        accessors = self.gltf.get("accessors", [])
        if not 0 <= index < len(accessors):
            raise GLTFError(f"accessor index {index} out of range")
        acc = accessors[index]
        if acc["type"] not in _TYPE_COUNTS:
            raise GLTFError(f"unsupported accessor type {acc['type']!r}")
        n = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        if not isinstance(count, int) or count < 0:
            raise GLTFError(f"invalid accessor count {count!r}")
        if acc["componentType"] not in _COMPONENT_DTYPES:
            raise GLTFError(
                f"unsupported accessor componentType {acc['componentType']!r}"
            )
        comp = _COMPONENT_DTYPES[acc["componentType"]]

        if "bufferView" in acc:
            out = self._view_data(
                acc["bufferView"], acc.get("byteOffset", 0), count, n, comp
            )
        else:
            out = np.zeros((count, n), comp)

        sparse = acc.get("sparse")
        if sparse:
            sc = sparse["count"]
            si = sparse["indices"]
            sv = sparse["values"]
            icomp = _COMPONENT_DTYPES[si["componentType"]]
            # sparse sub-views are tightly packed (spec forbids byteStride)
            isz = np.dtype(icomp).itemsize
            indices = self._view_data(
                si["bufferView"], si.get("byteOffset", 0), sc, 1, icomp,
                stride_override=isz,
            ).reshape(-1).astype(np.int64)
            vsz = np.dtype(comp).itemsize
            values = self._view_data(
                sv["bufferView"], sv.get("byteOffset", 0), sc, n, comp,
                stride_override=n * vsz,
            )
            if indices.size and (indices.max() >= count or indices.min() < 0):
                # signed component types could otherwise wrap via numpy
                # negative indexing and silently corrupt geometry
                raise GLTFError("sparse accessor index out of range")
            out = out.copy()
            out[indices] = values

        if acc.get("normalized", False) and comp in _NORM_SCALE:
            out = np.maximum(out.astype(np.float32) / _NORM_SCALE[comp], -1.0)
        return out

    def image_bytes(self, image_index: int) -> bytes:
        img = self.gltf["images"][image_index]
        if "bufferView" in img:
            bv = self.gltf["bufferViews"][img["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            off = bv.get("byteOffset", 0)
            return bytes(buf[off : off + bv["byteLength"]])
        uri = img["uri"]
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        with open(os.path.join(self.base_dir, _decode_uri(uri)), "rb") as f:
            return f.read()


def _load_buffers(gltf: dict, glb_bin: bytes | None, base_dir: str) -> list[bytes]:
    out = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if glb_bin is None:
                raise GLTFError("buffer without uri outside a .glb container")
            out.append(glb_bin)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, _decode_uri(uri)), "rb") as f:
                out.append(f.read())
    return out


def _decode_uri(uri: str) -> str:
    """External resource URIs are percent-encoded per the glTF 2.0 spec
    ('wood%20floor.bin' names the file 'wood floor.bin'); tinygltf decodes
    them in the reference."""
    from urllib.parse import unquote

    return unquote(uri)


def _parse_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<4sII", data, 0)
    if magic != b"glTF":
        raise GLTFError("bad GLB magic")
    if version != 2:
        raise GLTFError(f"unsupported GLB version {version}")
    off = 12
    json_chunk = None
    bin_chunk = None
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        chunk = data[off : off + clen]
        off += clen
        if ctype == 0x4E4F534A:  # 'JSON'
            json_chunk = chunk
        elif ctype == 0x004E4942:  # 'BIN'
            bin_chunk = chunk
    if json_chunk is None:
        raise GLTFError("GLB without JSON chunk")
    return json.loads(json_chunk), bin_chunk


def _synthesize_tangents(normals: np.ndarray) -> np.ndarray:
    """Perpendicular fallback (`rt/rtrt/loader.cu:381-390`)."""
    a, b, c = normals[:, 0], normals[:, 1], normals[:, 2]
    use_ab = (np.abs(a) > 1e-4) | (np.abs(b) > 1e-4)
    t1 = np.stack([-b, a, np.zeros_like(a)], axis=1)
    t2 = np.stack([np.zeros_like(a), -c, b], axis=1)
    t = np.where(use_ab[:, None], t1, t2)
    n = np.linalg.norm(t, axis=1, keepdims=True)
    return (t / np.where(n > 0, n, 1)).astype(np.float32)


def _load_primitive(model: _Model, prim: dict, name: str) -> Mesh:
    if prim.get("mode", MODE_TRIANGLES) != MODE_TRIANGLES:
        raise GLTFError(
            "mode of primitive other than TRIANGLES has not been supported yet; "
            "please triangulate the model first"
        )
    attrs = prim["attributes"]
    if "POSITION" not in attrs:
        raise GLTFError("POSITION is not set for a mesh")
    positions = model.accessor(attrs["POSITION"]).astype(np.float32)
    nv = positions.shape[0]
    if "NORMAL" not in attrs:
        raise GLTFError("missing normal")
    normals = model.accessor(attrs["NORMAL"]).astype(np.float32)

    if "TANGENT" in attrs:
        t4 = model.accessor(attrs["TANGENT"]).astype(np.float32)
        t = t4[:, :3]
        n = np.linalg.norm(t, axis=1, keepdims=True)
        tangents = (t / np.where(n > 0, n, 1)).astype(np.float32)
    else:
        warn(f"TANGENT is not set for {name}")
        tangents = _synthesize_tangents(normals)

    def uv(k):
        key = f"TEXCOORD_{k}"
        if key in attrs:
            return model.accessor(attrs[key]).astype(np.float32)[:, :2]
        return np.zeros((nv, 2), np.float32)

    if "COLOR_0" in attrs:
        c = model.accessor(attrs["COLOR_0"]).astype(np.float32)
        colors = c[:, :3]
    else:
        colors = np.ones((nv, 3), np.float32)

    if "indices" in prim:
        idx = model.accessor(prim["indices"]).astype(np.int64).reshape(-1)
    else:
        idx = np.arange(nv, dtype=np.int64)
    ntri = len(idx) // 3
    idx = idx[: ntri * 3].reshape(ntri, 3).astype(np.int32)

    return Mesh(
        positions,
        idx,
        normals=normals,
        tangents=tangents,
        colors=colors,
        uv0=uv(0),
        uv1=uv(1),
        name=name,
    )


def _decompose_matrix(m: np.ndarray):
    """glm::decompose-lite: column-major glTF matrix -> (T, R quat xyzw, S)."""
    m = np.asarray(m, np.float32).reshape(4, 4).T  # to row-major
    t = m[:3, 3].copy()
    basis = m[:3, :3].copy()
    s = np.linalg.norm(basis, axis=0)
    if np.linalg.det(basis) < 0:
        s[0] = -s[0]
    r = basis / s[None, :]
    # rotation matrix -> quaternion (x, y, z, w)
    tr = np.trace(r)
    if tr > 0:
        w = np.sqrt(1.0 + tr) / 2
        x = (r[2, 1] - r[1, 2]) / (4 * w)
        y = (r[0, 2] - r[2, 0]) / (4 * w)
        z = (r[1, 0] - r[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        q = np.zeros(4)
        q[i] = np.sqrt(max(0.0, 1 + r[i, i] - r[j, j] - r[k, k])) / 2
        q[j] = (r[j, i] + r[i, j]) / (4 * q[i])
        q[k] = (r[k, i] + r[i, k]) / (4 * q[i])
        q[3] = (r[k, j] - r[j, k]) / (4 * q[i])
        x, y, z, w = q
    return t, np.array([x, y, z, w], np.float32), s.astype(np.float32)


def _load_animations(model: _Model) -> dict[int, Animation]:
    """Per-node animation channels (`load_animations`,
    `rt/rtrt/loader.cu:692-733`)."""
    out: dict[int, Animation] = {}
    for anim in model.gltf.get("animations", []):
        for ch in anim.get("channels", []):
            path = ch["target"].get("path")
            node = ch["target"].get("node")
            if node is None:
                continue
            sampler = anim["samplers"][ch["sampler"]]
            if path not in ("translation", "scale", "rotation"):
                warn(f"unsupported path: {path}")
                continue
            times = model.accessor(sampler["input"]).astype(np.float32).reshape(-1)
            values = model.accessor(sampler["output"]).astype(np.float32)
            interp = sampler.get("interpolation", "LINEAR")
            step = interp == "STEP"
            if interp == "CUBICSPLINE":
                # output rows are (in-tangent, value, out-tangent) per key:
                # keep the value rows and lerp them — an approximation (the
                # reference ignores interpolation entirely and lerps the
                # raw 3K rows, i.e. garbage; `rt/rtrt/loader.cu:698-717`)
                warn("CUBICSPLINE animation approximated as LINEAR")
                values = values.reshape(len(times), 3, -1)[:, 1, :]
            a = out.setdefault(node, Animation())
            s = Sampler(times=times, values=values, step=step)
            if path == "translation":
                a.translation = s
            elif path == "scale":
                a.scale = s
            else:
                a.rotation = s  # quats stay (x, y, z, w); lerped, not slerped
    return out


class _TextureLoader:
    """Cached decode (`CachedTextureLoader`, `rt/rtrt/loader.cu:444-483`)."""

    def __init__(self, model: _Model, scene: HostScene):
        self.model = model
        self.scene = scene
        self.cache: dict[tuple[int, bool], int] = {}

    def load(self, tex_info, srgb: bool) -> tuple[int, int]:
        """-> (atlas texture id or NO_TEX, texCoord set)."""
        if not tex_info or tex_info.get("index", -1) < 0:
            return NO_TEX, 0
        index = tex_info["index"]
        uvset = tex_info.get("texCoord", 0)
        key = (index, srgb)
        if key in self.cache:
            return self.cache[key], uvset
        tex = self.model.gltf["textures"][index]
        src = tex.get("source", -1)
        if src < 0:
            return NO_TEX, uvset
        import io

        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "this glTF file has textures, and decoding them needs the "
                "Pillow package"
            ) from e

        data = self.model.image_bytes(src)
        img = Image.open(io.BytesIO(data)).convert("RGBA")
        arr = np.asarray(img, np.uint8)
        self.scene.textures.append(arr)
        self.scene.texture_srgb.append(srgb)
        tid = len(self.scene.textures) - 1
        self.cache[key] = tid
        return tid, uvset


def _load_material(model: _Model, mat: dict, loader: _TextureLoader) -> Material:
    """`load_material` (`rt/rtrt/loader.cu:485-545`)."""
    pbr = mat.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1, 1, 1, 1])
    out = Material(
        color=np.asarray(base[:3], np.float32),
        emission=np.asarray(mat.get("emissiveFactor", [0, 0, 0]), np.float32),
        metallic=float(pbr.get("metallicFactor", 1.0)),
        roughness=float(pbr.get("roughnessFactor", 1.0)),
        double_sided=bool(mat.get("doubleSided", False)),
    )
    out.tex_color, out.uv_color = loader.load(pbr.get("baseColorTexture"), True)
    out.tex_emission, out.uv_emission = loader.load(mat.get("emissiveTexture"), True)
    out.tex_metallic_roughness, out.uv_metallic_roughness = loader.load(
        pbr.get("metallicRoughnessTexture"), False
    )
    # glTF channel map: G=roughness, B=metallic (`rt/rtrt/loader.cu:517-525`)
    out.channel_roughness = 1
    out.channel_metallic = 2
    # normalTexture deliberately NOT loaded: the reference caches it
    # (`rt/rtrt/loader.cu:533-536`) but marks normal-map scale unsupported
    # (`rt/rtrt/memory.hpp:313`) and its shade kernel never samples it —
    # tex2D reads only the skybox and tex_color (`rt/rtrt/cuda.hpp:1789,
    # 1830, 1852`).  Skipping the dead upload keeps behavioural parity.
    return out


def _build_node(model: _Model, node_id: int, scene: HostScene,
                mesh_table, animations, parent: Object,
                _path: frozenset = frozenset()) -> Object:
    """`build_object_hierarchy` (`rt/rtrt/loader.cu:543-690`)."""
    if node_id in _path:  # a node cycle would otherwise recurse unboundedly
        raise GLTFError(f"node hierarchy cycle through node {node_id}")
    _path = _path | {node_id}
    node = model.gltf["nodes"][node_id]
    light_id = (
        node.get("extensions", {}).get("KHR_lights_punctual", {}).get("light", -1)
    )
    is_mesh = node.get("mesh", -1) >= 0
    is_camera = node.get("camera", -1) >= 0
    is_light = light_id >= 0
    if int(is_mesh) + int(is_camera) + int(is_light) > 1:
        raise GLTFError("an object can only be one of mesh, camera or light")

    if is_camera:
        cam = model.gltf["cameras"][node["camera"]]
        out = CameraObject()
        if cam.get("type") == "perspective":
            p = cam.get("perspective", {})
            out.aspect_ratio = float(p.get("aspectRatio", 1.0))
            out.fov_y = float(p.get("yfov", np.pi / 2))
            out.z_near = float(p.get("znear", 0.1))
            out.z_far = float(p.get("zfar", 100.0))
        elif cam.get("type") == "orthographic":
            warn("orthographic camera is not supported")
        else:
            raise GLTFError("invalid camera type")
        if scene.active_camera is None:
            scene.active_camera = out
    elif is_light:
        lights = model.gltf.get("extensions", {}).get("KHR_lights_punctual", {}).get(
            "lights", []
        )
        ldesc = lights[light_id]
        out = LightObject()
        rng = float(ldesc.get("range", 0) or 0)
        out.maximum_distance = rng if rng > 0 else np.inf
        intensity = float(ldesc.get("intensity", 1.0))
        ltype = ldesc.get("type")
        if ltype == "point":
            out.light_type = LIGHT_POINT
        elif ltype == "directional":
            out.light_type = LIGHT_DIRECTIONAL
        elif ltype == "spot":
            # spot mapped to point — reference quirk (`rt/rtrt/loader.cu:608-614`)
            out.light_type = LIGHT_POINT
            spot = ldesc.get("spot", {})
            out.inner_cone_angle = float(spot.get("innerConeAngle", 0.0))
            out.outer_cone_angle = float(spot.get("outerConeAngle", np.pi / 4))
        else:
            raise GLTFError("unexpected light type")
        color = ldesc.get("color", [1, 1, 1])
        out.intensity = np.asarray(
            [c * intensity for c in color], np.float32
        )
    elif is_mesh:
        out = Object()
        for mesh_id, material_id, (lo, hi) in mesh_table[node["mesh"]]:
            child = MeshObject(
                name=node.get("name", "") + " - MESH",
                mesh_id=mesh_id,
                material_id=material_id,
                aabb_lo=lo,
                aabb_hi=hi,
            )
            out.add(child)
    else:
        out = Object()

    if "matrix" in node:
        t, q, s = _decompose_matrix(node["matrix"])
        out.translation, out.rotation, out.scale = t, q, s
    else:
        if "translation" in node:
            out.translation = np.asarray(node["translation"], np.float32)
        if "rotation" in node:
            out.rotation = np.asarray(node["rotation"], np.float32)  # xyzw
        if "scale" in node:
            out.scale = np.asarray(node["scale"], np.float32)

    if node_id in animations:
        out.animation = animations[node_id]
        scene.animated = True

    out.name = node.get("name", "")
    out.parent = parent
    for child_id in node.get("children", []):
        out.children.append(
            _build_node(model, child_id, scene, mesh_table, animations, out,
                        _path=_path)
        )
    return out


def load_gltf(path: str, scene: HostScene | None = None) -> HostScene:
    """`load_gltf2` (`rt/rtrt/loader.cu:736-828`).  Appends into an existing
    HostScene when given (multi-file material_offset behaviour).

    All malformed-asset failures surface as :class:`GLTFError` (the
    reference's loader throws typed exceptions for corrupted glTF,
    `rt/rtrt/loader.cu:94, 101-103, 201-204`, which the UI console catches);
    raw KeyError/IndexError/decode errors never escape this boundary."""
    try:
        return _load_gltf_checked(path, scene)
    except GLTFError:
        raise
    except (KeyError, IndexError, ValueError, TypeError, OSError,
            struct.error, RecursionError) as e:
        raise GLTFError(
            f"malformed glTF {path!r}: {type(e).__name__}: {e}"
        ) from e


def _load_gltf_checked(path: str, scene: HostScene | None = None) -> HostScene:
    ext = os.path.splitext(path)[1].lower()
    base_dir = os.path.dirname(os.path.abspath(path))
    if ext == ".glb":
        with open(path, "rb") as f:
            gltf, glb_bin = _parse_glb(f.read())
    elif ext == ".gltf":
        with open(path, "r", encoding="utf-8") as f:
            gltf = json.load(f)
        glb_bin = None
    else:
        raise GLTFError(f"the extension of glTF2 file (`{path}`) should be .glb or .gltf")

    model = _Model(gltf, _load_buffers(gltf, glb_bin, base_dir), base_dir)

    if scene is None:
        scene = HostScene()
    # default material at id 0 (`rt/rtrt/loader.cu:774-776`)
    if not scene.materials:
        scene.materials.append(Material())
    material_offset = len(scene.materials)

    loader = _TextureLoader(model, scene)
    for mat in model.gltf.get("materials", []):
        scene.materials.append(_load_material(model, mat, loader))

    # meshes: one framework Mesh per glTF primitive (a reference "VAO")
    mesh_table = []
    for gmesh in model.gltf.get("meshes", []):
        entries = []
        for prim in gmesh.get("primitives", []):
            m = _load_primitive(model, prim, gmesh.get("name", ""))
            mesh_id = scene.add_mesh(m)
            mat = prim.get("material", -1)
            material_id = mat + material_offset if mat >= 0 else 0
            entries.append((mesh_id, material_id, m.aabb))
        mesh_table.append(entries)

    animations = _load_animations(model)

    root = scene.root
    scene_idx = model.gltf.get("scene", 0)
    scenes = model.gltf.get("scenes", [{}])
    for node_id in scenes[scene_idx].get("nodes", []):
        root.children.append(
            _build_node(model, node_id, scene, mesh_table, animations, root)
        )
    return scene
