import numpy as np
import pytest

from gltf_writer import GLBBuilder, cube_glb

from low_precision_raytracer.models.gltf import GLTFError, load_gltf
from low_precision_raytracer.models.hierarchy import (
    LIGHT_POINT,
    CameraObject,
    LightObject,
    MeshObject,
)


def test_load_cube_glb(tmp_path):
    path = str(tmp_path / "cube.glb")
    cube_glb(path, with_texture=True, with_light=True, with_camera=True)
    scene = load_gltf(path)
    assert len(scene.meshes) == 1
    assert scene.meshes[0].n_triangles == 12
    # default material at 0 + the cube's material
    assert len(scene.materials) == 2
    assert len(scene.textures) == 1
    assert scene.texture_srgb[0] is True
    assert scene.active_camera is not None
    # cube node carries a MeshObject child with material id 1
    meshes = [n for n in scene.root.walk() if isinstance(n, MeshObject)]
    assert len(meshes) == 1
    assert meshes[0].material_id == 1
    # spot light mapped to point (reference quirk)
    lights = [n for n in scene.root.walk() if isinstance(n, LightObject)]
    assert len(lights) == 2
    assert all(l.light_type == LIGHT_POINT for l in lights)
    # material factors
    np.testing.assert_allclose(scene.materials[1].color, [0.8, 0.3, 0.2], atol=1e-6)
    assert scene.materials[1].tex_color == 0


def test_tangent_synthesis(tmp_path):
    b = GLBBuilder()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    nrm = np.tile([0, 0, 1], (3, 1)).astype(np.float32)
    mid = b.add_mesh(pos, [0, 1, 2], normals=nrm, name="tri")
    b.add_node(mesh=mid)
    path = str(tmp_path / "tri.glb")
    b.write_glb(path)
    scene = load_gltf(path)
    t = scene.meshes[0].tangents
    # synthesized perpendicular: normal (0,0,1) -> branch 2 -> (0,-1,0)
    np.testing.assert_allclose(np.abs(t[0]), [0, 1, 0], atol=1e-6)
    dots = np.sum(t * scene.meshes[0].normals, axis=1)
    np.testing.assert_allclose(dots, 0, atol=1e-5)


def test_animation_interpolation_modes(tmp_path):
    """STEP holds the segment's start value exactly; CUBICSPLINE loads its
    value rows (in-tangent, VALUE, out-tangent triplets) and lerps them —
    the reference lerps the raw 3K rows, i.e. garbage (`loader.cu:698`)."""
    b = GLBBuilder()
    n = b.add_node(name="stepper")
    b.add_animation(n, "translation", [0, 1, 2], [[0, 0, 0], [0, 1, 0], [0, 2, 0]],
                    interpolation="STEP")
    n2 = b.add_node(name="spliner")
    # CUBICSPLINE: (in-tangent, value, out-tangent) per key
    cs = [[9, 9, 9], [0, 0, 0], [9, 9, 9],
          [9, 9, 9], [0, 4, 0], [9, 9, 9]]
    b.add_animation(n2, "translation", [0, 1], cs, interpolation="CUBICSPLINE")
    path = str(tmp_path / "interp.glb")
    b.write_glb(path)
    scene = load_gltf(path)
    scene.root.apply_animation(0.75)
    stepper = scene.root.search("stepper")
    np.testing.assert_allclose(stepper.translation, [0, 0, 0], atol=1e-6)  # held
    spliner = scene.root.search("spliner")
    # value rows lerped: 0.75 between [0,0,0] and [0,4,0]
    np.testing.assert_allclose(spliner.translation, [0, 3, 0], atol=1e-5)


def _triangle_builder():
    b = GLBBuilder()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    nrm = np.tile([0, 0, 1], (3, 1)).astype(np.float32)
    mid = b.add_mesh(pos, [0, 1, 2], normals=nrm)
    b.add_node(name="tri", mesh=mid)
    return b


def test_external_buffer_percent_encoded_uri(tmp_path):
    """glTF external resource URIs are percent-encoded; 'my%20buf.bin'
    names the file 'my buf.bin' (tinygltf decodes these in the reference)."""
    import json

    b = _triangle_builder()
    g = b.gltf_dict()
    (tmp_path / "my buf.bin").write_bytes(bytes(b.bin))
    g["buffers"][0]["uri"] = "my%20buf.bin"
    p = tmp_path / "ext.gltf"
    p.write_text(json.dumps(g))
    scene = load_gltf(str(p))
    assert scene.meshes and scene.meshes[0].n_triangles == 1


def test_node_cycle_raises_gltferror(tmp_path):
    import base64
    import json

    b = _triangle_builder()
    g = b.gltf_dict()
    g["nodes"][0].setdefault("children", []).append(0)  # node is its own child
    g["buffers"][0]["uri"] = (
        "data:application/octet-stream;base64,"
        + base64.b64encode(bytes(b.bin)).decode()
    )
    p = tmp_path / "cycle.gltf"
    p.write_text(json.dumps(g))
    with pytest.raises(GLTFError):
        load_gltf(str(p))


def test_animation_channels(tmp_path):
    path = str(tmp_path / "anim.glb")
    cube_glb(path, with_animation=True)
    scene = load_gltf(path)
    assert scene.animated
    cube = scene.root.search("cube")
    assert cube is not None
    scene.root.apply_animation(1.0)
    np.testing.assert_allclose(cube.translation, [0, 1, 0], atol=1e-5)
    # lerp (not slerp) between keyframes
    scene.root.apply_animation(0.5)
    np.testing.assert_allclose(cube.translation, [0, 0.5, 0], atol=1e-5)
    # rotation channel present and normalized before use
    m = cube.transform_matrix()
    assert np.isfinite(m).all()


def test_matrix_node_decompose(tmp_path):
    b = GLBBuilder()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    nrm = np.tile([0, 0, 1], (3, 1)).astype(np.float32)
    mid = b.add_mesh(pos, [0, 1, 2], normals=nrm)
    from low_precision_raytracer.math.hostmath import trs_matrix

    q = np.array([0, np.sin(np.pi / 8), 0, np.cos(np.pi / 8)], np.float32)
    m = trs_matrix([1, 2, 3], q, [2, 2, 2])
    b.add_node(mesh=mid, matrix=m)
    path = str(tmp_path / "mat.glb")
    b.write_glb(path)
    scene = load_gltf(path)
    node = scene.root.children[0]
    np.testing.assert_allclose(node.translation, [1, 2, 3], atol=1e-5)
    np.testing.assert_allclose(node.scale, [2, 2, 2], atol=1e-5)
    np.testing.assert_allclose(np.abs(node.rotation), np.abs(q), atol=1e-5)
    # recomposed matrix matches
    np.testing.assert_allclose(node.transform_matrix(), m, atol=1e-4)


def test_gltf_json_variant(tmp_path):
    """.gltf with embedded base64 buffer."""
    import base64
    import json

    b = GLBBuilder()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    nrm = np.tile([0, 0, 1], (3, 1)).astype(np.float32)
    mid = b.add_mesh(pos, [0, 1, 2], normals=nrm)
    b.add_node(mesh=mid)
    g = b.gltf_dict()
    g["buffers"][0]["uri"] = "data:application/octet-stream;base64," + base64.b64encode(
        bytes(b.bin)
    ).decode()
    path = tmp_path / "tri.gltf"
    path.write_text(json.dumps(g))
    scene = load_gltf(str(path))
    assert scene.meshes[0].n_triangles == 1
    np.testing.assert_allclose(scene.meshes[0].positions, pos)


def test_bad_extension(tmp_path):
    p = tmp_path / "scene.obj"
    p.write_text("")
    with pytest.raises(GLTFError):
        load_gltf(str(p))


def test_render_from_glb(tmp_path):
    """Loaded scene renders end-to-end (BASELINE config 1 via glTF)."""
    path = str(tmp_path / "cube.glb")
    cube_glb(path, with_texture=True)
    scene = load_gltf(path)
    from low_precision_raytracer.config import RenderConfig
    from low_precision_raytracer.render.renderer import Renderer

    cfg = RenderConfig(width=32, height=32, precision="fp32", gi_on=False, taa_on=False)
    img, aux = Renderer(scene, cfg).render()
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert np.asarray(aux["valid"]).mean() > 0.05
    assert img.max() > 0.01


def test_sparse_accessor_foreign_asset():
    """A hand-authored .gltf (text format, data-URI buffer, sparse POSITION
    accessor, KHR light + camera) — a loader oracle independent of this
    repo's own GLB writer.  Reference handles sparse via tinygltf's decoded
    buffers (`rt/rtrt/loader.cu:52-190`)."""
    import os

    path = os.path.join(os.path.dirname(__file__), "assets", "sparse_quad.gltf")
    scene = load_gltf(path)
    assert len(scene.meshes) == 1
    mesh = scene.meshes[0]
    # base quad with vertex 2 displaced by the sparse substitution
    np.testing.assert_allclose(
        mesh.positions,
        np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 2], [-1, 1, 0]], np.float32),
    )
    assert mesh.indices.shape == (2, 3)
    assert scene.active_camera is not None
    light = scene.root.search("lamp")
    assert light is not None
    np.testing.assert_allclose(light.intensity, [40.0, 36.0, 32.0])


def test_sparse_accessor_renders():
    """End-to-end: the sparse-displaced geometry actually traces."""
    import os

    from low_precision_raytracer.config import DemoSettings, RenderConfig
    from low_precision_raytracer.render.renderer import Renderer

    path = os.path.join(os.path.dirname(__file__), "assets", "sparse_quad.gltf")
    scene = load_gltf(path)
    cfg = RenderConfig(width=32, height=32, precision="fp32", gi_on=False,
                       taa_on=False, demo=DemoSettings(svgf=False))
    img, aux = Renderer(scene, cfg).render()
    assert np.isfinite(np.asarray(img)).all()
    assert np.asarray(aux["valid"]).mean() > 0.2  # quad covers the view


# ---- foreign-exporter-layout assets (Khronos `Box` / `BoxInterleaved`
# sample structure, COLLADA2GLTF output — see tests/assets/make_khronos_box.py
# for why they are offline reconstructions).  These exercise everything the
# repo's own writer never emits: separate .bin buffers by relative uri, a
# SHARED strided bufferView, interleaved vertex data (byteStride 24), node
# `matrix` (not TRS), ushort indices, and named mesh/material entries.
# Loader parity target: `rt/rtrt/loader.cu:52-190, 736-828`.

def _asset(name):
    import os

    return os.path.join(os.path.dirname(__file__), "assets", name)


def test_khronos_box_gltf_layout():
    scene = load_gltf(_asset("Box.gltf"))
    mesh = scene.meshes[0]
    assert mesh.n_triangles == 12
    assert mesh.positions.shape == (24, 3)
    # positions live at byteOffset 288 of the shared strided bufferView;
    # a wrong stride/offset would read normals (unit vectors) instead
    np.testing.assert_allclose(mesh.positions.min(axis=0), [-0.5] * 3)
    np.testing.assert_allclose(mesh.positions.max(axis=0), [0.5] * 3)
    assert np.all(np.isin(np.abs(mesh.normals), [0.0, 1.0]))
    # COLLADA2GLTF "Red" material
    np.testing.assert_allclose(scene.materials[1].color, [0.8, 0, 0], atol=1e-6)
    assert scene.materials[1].metallic == 0.0
    assert scene.materials[1].roughness == 1.0
    # the root node carries the Z-up -> Y-up `matrix`: its decomposed TRS
    # must still map the cube onto itself (+-0.5 world AABB)
    mesh_nodes = [n for n in scene.root.walk() if isinstance(n, MeshObject)]
    assert len(mesh_nodes) == 1


def test_khronos_box_interleaved_glb_cross_layout():
    """The interleaved GLB and the separate-.bin gltf decode to identical
    geometry — a cross-layout oracle that does not depend on this repo's
    writer (two foreign layouts must agree with each other)."""
    s1 = load_gltf(_asset("Box.gltf"))
    s2 = load_gltf(_asset("BoxInterleaved.glb"))
    m1, m2 = s1.meshes[0], s2.meshes[0]
    np.testing.assert_array_equal(m1.positions, m2.positions)
    np.testing.assert_array_equal(m1.normals, m2.normals)
    np.testing.assert_array_equal(m1.indices, m2.indices)
    np.testing.assert_allclose(s1.materials[1].color, s2.materials[1].color)


def test_khronos_box_renders_red():
    """End-to-end render of the foreign-layout asset: rig the CLI's default
    camera, render, and check the cube shows up red-dominant at the image
    center (material baseColorFactor [0.8, 0, 0])."""
    from low_precision_raytracer.config import DemoSettings, RenderConfig
    from low_precision_raytracer.models.hierarchy import (
        CameraObject,
        LightObject,
    )
    from low_precision_raytracer.render.renderer import Renderer

    scene = load_gltf(_asset("Box.gltf"))
    cam = CameraObject(name="cam", fov_y=np.pi / 3)
    cam.translation = np.array([0.0, 0.0, 2.0], np.float32)
    scene.root.add(cam)
    scene.active_camera = cam
    lamp = LightObject(name="lamp", light_type=LIGHT_POINT,
                       intensity=np.array([30.0, 30.0, 30.0], np.float32))
    lamp.translation = np.array([1.0, 1.5, 2.0], np.float32)
    scene.root.add(lamp)
    cfg = RenderConfig(width=48, height=48, precision="fp32", gi_on=False,
                       taa_on=False, demo=DemoSettings(svgf=False))
    img, aux = Renderer(scene, cfg).render()
    img = np.asarray(img)
    assert np.isfinite(img).all()
    center = img[20:28, 20:28]
    assert np.asarray(aux["valid"])[20:28, 20:28].all()
    assert center[..., 0].mean() > 2 * center[..., 1].mean()
    assert center[..., 0].mean() > 0.05


def test_khronos_boxtextured_layout():
    """`BoxTextured` sample structure: TEXCOORD_0 from its own strided
    bufferView, file-uri PNG image, samplers table, material color carried
    by baseColorTexture (`rt/rtrt/loader.cu:444-541`)."""
    from low_precision_raytracer.models.materials import NO_TEX

    scene = load_gltf(_asset("BoxTextured.gltf"))
    mesh = scene.meshes[0]
    # geometry identical to the untextured foreign-layout cube
    ref = load_gltf(_asset("Box.gltf")).meshes[0]
    np.testing.assert_array_equal(mesh.positions, ref.positions)
    np.testing.assert_array_equal(mesh.indices, ref.indices)
    # the vec2 accessor decoded through byteStride 8 (not the vec3 stride)
    assert mesh.uv0.shape == (24, 2)
    np.testing.assert_allclose(mesh.uv0.min(axis=0), [0.0, 0.0])
    np.testing.assert_allclose(mesh.uv0.max(axis=0), [1.0, 1.0])
    mat = scene.materials[1]
    assert mat.tex_color != NO_TEX
    assert mat.uv_color == 0
    np.testing.assert_allclose(mat.color, [1.0, 1.0, 1.0])  # factor default
    # sRGB decode flagged for the base-color texture; checker uploaded as-is
    assert scene.texture_srgb[mat.tex_color] is True
    tex = scene.textures[mat.tex_color]
    assert tex.shape == (64, 64, 4)
    assert set(np.unique(tex[..., 0])) == {204, 255}


def test_khronos_boxtextured_renders_checker():
    """End-to-end: the rendered +Z face must show the checkerboard — both
    red cells (G << R) and white cells (G ~ R) present in the same face."""
    from low_precision_raytracer.config import DemoSettings, RenderConfig
    from low_precision_raytracer.models.hierarchy import (
        CameraObject,
        LightObject,
    )
    from low_precision_raytracer.render.renderer import Renderer

    scene = load_gltf(_asset("BoxTextured.gltf"))
    cam = CameraObject(name="cam", fov_y=np.pi / 3)
    cam.translation = np.array([0.0, 0.0, 2.0], np.float32)
    scene.root.add(cam)
    scene.active_camera = cam
    lamp = LightObject(name="lamp", light_type=LIGHT_POINT,
                       intensity=np.array([40.0, 40.0, 40.0], np.float32))
    lamp.translation = np.array([0.0, 0.0, 2.5], np.float32)
    scene.root.add(lamp)
    cfg = RenderConfig(width=64, height=64, precision="fp32", gi_on=False,
                       taa_on=False, demo=DemoSettings(svgf=False))
    img, aux = Renderer(scene, cfg).render()
    img = np.asarray(img)
    assert np.isfinite(img).all()
    face = img[24:40, 24:40]
    assert np.asarray(aux["valid"])[24:40, 24:40].all()
    ratio = face[..., 1] / np.maximum(face[..., 0], 1e-6)
    # red checker cells: green a small fraction of red; white cells: ~equal
    assert ratio.min() < 0.25
    assert ratio.max() > 0.8


def test_malformed_gltf_raises_typed_errors(tmp_path):
    """Every malformed-asset failure must surface as GLTFError (the
    reference's loader throws typed exceptions the UI console catches,
    `rt/rtrt/loader.cu:94, 101-103, 201-204`) — never a raw KeyError/
    IndexError/OSError from parser internals."""
    import json as _json
    import shutil

    base = _json.load(open(_asset("BoxTextured.gltf")))
    for f in ("BoxTextured0.bin", "BoxTexturedCheck.png"):
        shutil.copy(_asset(f), tmp_path)

    def check(mutator):
        g = _json.loads(_json.dumps(base))
        mutator(g)
        p = tmp_path / "m.gltf"
        p.write_text(_json.dumps(g))
        with pytest.raises(GLTFError):
            load_gltf(str(p))

    check(lambda g: g.pop("buffers"))
    check(lambda g: g.pop("accessors"))
    check(lambda g: g["meshes"][0]["primitives"][0]["attributes"]
          .__setitem__("POSITION", 99))
    check(lambda g: g["accessors"][0].__setitem__("bufferView", 42))
    check(lambda g: g["accessors"][1].__setitem__("componentType", 1234))
    check(lambda g: g["bufferViews"][1].__setitem__("byteOffset", 820))
    check(lambda g: g.pop("nodes"))
    check(lambda g: g["images"][0].__setitem__("uri", "missing.png"))
    check(lambda g: g["nodes"][1].__setitem__("mesh", 7))
    check(lambda g: g["accessors"][0].__setitem__("count", -5))
    check(lambda g: g["meshes"][0]["primitives"][0].__setitem__("indices", 77))
