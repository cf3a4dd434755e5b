"""Minimal glTF 2.0 writer for test assets (no egress: we generate our own
.glb/.gltf files to exercise the loader)."""

from __future__ import annotations

import json
import struct

import numpy as np


class GLBBuilder:
    def __init__(self):
        self.bin = bytearray()
        self.buffer_views = []
        self.accessors = []
        self.meshes = []
        self.materials = []
        self.textures = []
        self.images = []
        self.nodes = []
        self.scene_nodes = []
        self.cameras = []
        self.lights = []
        self.animations = []

    def _align(self, n=4):
        while len(self.bin) % n:
            self.bin.append(0)

    def add_buffer_view(self, data: bytes) -> int:
        self._align()
        off = len(self.bin)
        self.bin.extend(data)
        self.buffer_views.append(
            {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        )
        return len(self.buffer_views) - 1

    def add_accessor(self, arr: np.ndarray, type_: str, component: int, normalized=False) -> int:
        bv = self.add_buffer_view(arr.tobytes())
        acc = {
            "bufferView": bv,
            "componentType": component,
            "count": int(arr.shape[0]),
            "type": type_,
        }
        if normalized:
            acc["normalized"] = True
        if type_ == "VEC3" and component == 5126:
            acc["min"] = arr.min(axis=0).tolist()
            acc["max"] = arr.max(axis=0).tolist()
        if type_ == "SCALAR" and component == 5126:
            acc["min"] = [float(arr.min())]
            acc["max"] = [float(arr.max())]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_mesh(self, positions, indices, normals=None, uv0=None, tangents=None,
                 colors=None, material=None, name="mesh") -> int:
        positions = np.asarray(positions, np.float32)
        attrs = {"POSITION": self.add_accessor(positions, "VEC3", 5126)}
        if normals is not None:
            attrs["NORMAL"] = self.add_accessor(np.asarray(normals, np.float32), "VEC3", 5126)
        if tangents is not None:
            attrs["TANGENT"] = self.add_accessor(np.asarray(tangents, np.float32), "VEC4", 5126)
        if uv0 is not None:
            attrs["TEXCOORD_0"] = self.add_accessor(np.asarray(uv0, np.float32), "VEC2", 5126)
        if colors is not None:
            attrs["COLOR_0"] = self.add_accessor(np.asarray(colors, np.float32), "VEC4", 5126)
        prim = {
            "attributes": attrs,
            "indices": self.add_accessor(
                np.asarray(indices, np.uint16).reshape(-1, 1), "SCALAR", 5123
            ),
            "mode": 4,
        }
        if material is not None:
            prim["material"] = material
        self.meshes.append({"name": name, "primitives": [prim]})
        return len(self.meshes) - 1

    def add_material(self, base_color=(1, 1, 1, 1), metallic=0.0, roughness=1.0,
                     emissive=(0, 0, 0), double_sided=False, base_color_texture=None) -> int:
        mat = {
            "pbrMetallicRoughness": {
                "baseColorFactor": list(base_color),
                "metallicFactor": metallic,
                "roughnessFactor": roughness,
            },
            "emissiveFactor": list(emissive),
            "doubleSided": double_sided,
        }
        if base_color_texture is not None:
            mat["pbrMetallicRoughness"]["baseColorTexture"] = {"index": base_color_texture}
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_texture_png(self, rgba: np.ndarray) -> int:
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(np.asarray(rgba, np.uint8)).save(buf, format="PNG")
        bv = self.add_buffer_view(buf.getvalue())
        self.images.append({"bufferView": bv, "mimeType": "image/png"})
        self.textures.append({"source": len(self.images) - 1})
        return len(self.textures) - 1

    def add_node(self, name="", mesh=None, camera=None, light=None, translation=None,
                 rotation=None, scale=None, matrix=None, children=(), root=True) -> int:
        node = {"name": name}
        if mesh is not None:
            node["mesh"] = mesh
        if camera is not None:
            node["camera"] = camera
        if light is not None:
            node["extensions"] = {"KHR_lights_punctual": {"light": light}}
        if matrix is not None:
            node["matrix"] = list(np.asarray(matrix, np.float32).T.reshape(-1).astype(float))
        else:
            if translation is not None:
                node["translation"] = list(map(float, translation))
            if rotation is not None:
                node["rotation"] = list(map(float, rotation))
            if scale is not None:
                node["scale"] = list(map(float, scale))
        if children:
            node["children"] = list(children)
        self.nodes.append(node)
        nid = len(self.nodes) - 1
        if root:
            self.scene_nodes.append(nid)
        return nid

    def add_camera(self, yfov=1.0, znear=0.1, zfar=100.0, aspect=1.0) -> int:
        self.cameras.append(
            {
                "type": "perspective",
                "perspective": {"yfov": yfov, "znear": znear, "zfar": zfar, "aspectRatio": aspect},
            }
        )
        return len(self.cameras) - 1

    def add_light(self, type_="point", color=(1, 1, 1), intensity=1.0, **spot) -> int:
        light = {"type": type_, "color": list(color), "intensity": intensity}
        if spot:
            light["spot"] = spot
        self.lights.append(light)
        return len(self.lights) - 1

    def add_animation(self, node: int, path: str, times, values,
                      interpolation: str = "LINEAR") -> None:
        times = np.asarray(times, np.float32).reshape(-1, 1)
        values = np.asarray(values, np.float32)
        t_acc = self.add_accessor(times, "SCALAR", 5126)
        v_type = "VEC4" if path == "rotation" else "VEC3"
        v_acc = self.add_accessor(values, v_type, 5126)
        if not self.animations:
            self.animations.append({"channels": [], "samplers": []})
        anim = self.animations[0]
        anim["samplers"].append(
            {"input": t_acc, "output": v_acc, "interpolation": interpolation}
        )
        anim["channels"].append(
            {"sampler": len(anim["samplers"]) - 1, "target": {"node": node, "path": path}}
        )

    def gltf_dict(self) -> dict:
        g = {
            "asset": {"version": "2.0"},
            "scene": 0,
            "scenes": [{"nodes": self.scene_nodes}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "accessors": self.accessors,
            "bufferViews": self.buffer_views,
            "buffers": [{"byteLength": len(self.bin)}],
        }
        if self.materials:
            g["materials"] = self.materials
        if self.textures:
            g["textures"] = self.textures
            g["images"] = self.images
        if self.cameras:
            g["cameras"] = self.cameras
        if self.lights:
            g["extensions"] = {"KHR_lights_punctual": {"lights": self.lights}}
            g["extensionsUsed"] = ["KHR_lights_punctual"]
        if self.animations:
            g["animations"] = self.animations
        return g

    def write_glb(self, path: str) -> None:
        self._align()
        js = json.dumps(self.gltf_dict()).encode()
        while len(js) % 4:
            js += b" "
        binc = bytes(self.bin)
        total = 12 + 8 + len(js) + 8 + len(binc)
        with open(path, "wb") as f:
            f.write(struct.pack("<4sII", b"glTF", 2, total))
            f.write(struct.pack("<II", len(js), 0x4E4F534A))
            f.write(js)
            f.write(struct.pack("<II", len(binc), 0x004E4942))
            f.write(binc)


def cube_glb(path: str, with_texture=False, with_light=True, with_camera=True,
             with_animation=False) -> None:
    """A small but feature-covering .glb: cube mesh + material (+texture),
    point light, spot light (should map to point), camera, TRS animation."""
    from low_precision_raytracer.models.procedural import cube_mesh

    b = GLBBuilder()
    mesh = cube_mesh(1.0)
    tex = None
    if with_texture:
        checker = np.zeros((8, 8, 4), np.uint8)
        checker[::2, ::2] = [255, 255, 255, 255]
        checker[1::2, 1::2] = [255, 255, 255, 255]
        checker[..., 3] = 255
        tex = b.add_texture_png(checker)
    mat = b.add_material(base_color=(0.8, 0.3, 0.2, 1.0), metallic=0.1, roughness=0.6,
                         base_color_texture=tex)
    t4 = np.concatenate([mesh.tangents, np.ones((len(mesh.tangents), 1), np.float32)], axis=1)
    mid = b.add_mesh(mesh.positions, mesh.indices.reshape(-1), normals=mesh.normals,
                     uv0=mesh.uv0, tangents=t4, material=mat, name="cube")
    cube_node = b.add_node(name="cube", mesh=mid, translation=(0, 0, 0))
    if with_animation:
        b.add_animation(cube_node, "translation", [0, 1, 2], [[0, 0, 0], [0, 1, 0], [0, 0, 0]])
        b.add_animation(cube_node, "rotation", [0, 2],
                        [[0, 0, 0, 1], [0, float(np.sin(np.pi / 4)), 0, float(np.cos(np.pi / 4))]])
    if with_light:
        pl = b.add_light("point", (1, 1, 1), 50.0)
        b.add_node(name="lamp", light=pl, translation=(2, 3, 2))
        sl = b.add_light("spot", (1, 0.5, 0.5), 20.0, innerConeAngle=0.2, outerConeAngle=0.5)
        b.add_node(name="spot", light=sl, translation=(-2, 3, 2))
    if with_camera:
        cam = b.add_camera(yfov=1.0)
        b.add_node(name="cam", camera=cam, translation=(0, 0.5, 3.5))
    b.write_glb(path)
