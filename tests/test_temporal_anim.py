"""BASELINE config 4: animated scene with temporal reprojection + SVGF, and
config 5 smoke: colonnade scene with skybox IBL."""

import numpy as np

from low_precision_raytracer.config import RenderConfig
from low_precision_raytracer.models.procedural import (
    animated_cornell_scene,
    sponza_like_scene,
)
from low_precision_raytracer.render.renderer import Renderer


def test_animated_scene_renders_and_reprojects():
    cfg = RenderConfig(width=32, height=32, precision="fp32", gi_on=True,
                       taa_mix_weight=0.3)
    r = Renderer(animated_cornell_scene(), cfg)
    imgs = []
    for f in range(3):
        img, aux = r.render(time=f / 3.0)
        imgs.append(np.asarray(img))
        assert np.isfinite(imgs[-1]).all()
    # the tall box moves: successive frames differ
    assert np.abs(imgs[1] - imgs[0]).max() > 1e-3
    # reprojection found history on static background pixels:
    # frame counts accumulate past 1 somewhere
    assert int(np.asarray(r.state.svgf_frame_count).max()) >= 2
    # object motion updated the per-mesh L2W backup
    l2w = np.asarray(r.state.last_l2w, np.float32)
    assert not np.allclose(l2w[1], np.eye(4), atol=1e-5)  # cube mesh moved


def test_sponza_like_scene_with_skybox():
    host = sponza_like_scene(pillar_grid=2, sphere_subdiv=1)
    cfg = RenderConfig(width=32, height=32, precision="fp32", gi_on=True)
    r = Renderer(host, cfg)
    img, aux = r.render()
    img = np.asarray(img)
    assert np.isfinite(img).all()
    # skybox fills the miss pixels with nonzero radiance
    valid = np.asarray(aux["valid"])
    assert valid.mean() < 1.0  # some sky visible
    sky_px = img[~valid]
    assert sky_px.size > 0 and sky_px.mean() > 0.05
    # lit geometry present too
    assert img[valid].mean() > 0.02


def test_sponza_scene_tri_count_scales():
    small = sponza_like_scene(pillar_grid=2, sphere_subdiv=1)
    big = sponza_like_scene(pillar_grid=4, sphere_subdiv=3)
    n_small = sum(m.n_triangles for m in small.meshes)
    n_big = sum(m.n_triangles for m in big.meshes)
    assert n_big > n_small
    # instance-triangle count of the big variant exceeds the dense gate
    inst = sum(
        big.meshes[0].n_triangles if False else 0 for _ in ()
    )
    total_inst = 0
    from low_precision_raytracer.models.hierarchy import MeshObject

    for node in big.root.walk():
        if isinstance(node, MeshObject):
            total_inst += big.meshes[node.mesh_id].n_triangles
    assert total_inst > 8192  # forces the BVH path under 'auto'
