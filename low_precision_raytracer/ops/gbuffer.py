"""Traced primary-visibility G-buffer (`fill_gbuffer_in_cuda`,
`rt/rtrt/cuda.hpp:950-1012`).

Here this is THE primary-ray pass — the reference's OpenGL raster path
(SURVEY.md 2.13) has no equivalent and its traced alternative becomes the
default.  Produces a dict of SoA pixel arrays instead of 7 MRT surfaces.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from low_precision_raytracer.config import Precision, RenderConfig
from low_precision_raytracer.math.vec import normalize
from low_precision_raytracer.ops.trace import trace
from low_precision_raytracer.ops.traversal import Hit


def interpolate_hit_attributes(scene, frame, hit: Hit, dtype):
    """Barycentric attribute interpolation + local-to-world transform
    (shared by the G-buffer pass and `trace_gi`, `rt/rtrt/cuda.hpp:966-988,
    2108-2131`).

    Like the reference, normals/tangents are transformed by L2W directly
    (no inverse-transpose), so non-uniform scale skews them identically.

    Small scenes use the one-hot-matmul path: a gather from a small table
    written as an ``(R, T) @ (T, C)`` matmul instead of scalar gathers.
    """
    if scene.tri_attr is not None:
        return _interpolate_onehot(scene, frame, hit, dtype)
    return _interpolate_gather(scene, frame, hit, dtype)


def _finish_world(frame_l2w_rows, position, normal, tangent):
    """World transform on (R, 4, 4)-gathered rows."""
    rot = frame_l2w_rows[..., :3, :3]
    normal = normalize((rot @ normal[..., :, None])[..., 0])
    tangent = normalize((rot @ tangent[..., :, None])[..., 0])
    pos_w = (rot @ position[..., :, None])[..., 0] + frame_l2w_rows[..., :3, 3]
    return pos_w, normal, tangent


def _interpolate_onehot(scene, frame, hit: Hit, dtype):
    dt = dtype
    R = hit.tri.shape[0]
    T = scene.tri_attr.shape[0]
    O = frame.obj_l2w.shape[0]

    u = hit.u.astype(dt)[..., None]
    v = hit.v.astype(dt)[..., None]
    w = (1.0 - hit.u - hit.v).astype(dt)[..., None]

    # bound per-chunk (rays, T) one-hot size; misses (tri = -1) -> zero rows
    chunk = max(min(64 * 1024 * 1024 // max(T, 1), R), 1024)

    def interp_chunk(args):
        tri_c, obj_c, u_c, v_c, w_c = args
        # the big (R, T) one-hot rides in the TABLE's dtype (bf16 scene
        # storage): 0/1 is exact in any dtype, bf16-in/f32-accumulate is
        # the matrix units' fast mode, and the bf16 table bounds the
        # accuracy either way
        onehot_t = (
            tri_c[:, None] == jnp.arange(T, dtype=jnp.int32)[None, :]
        ).astype(scene.tri_attr.dtype)
        a = jnp.dot(onehot_t, scene.tri_attr, preferred_element_type=jnp.float32)
        a = a.astype(dt)
        a0, a1, a2 = a[:, 0:16], a[:, 16:32], a[:, 32:48]
        attr = u_c * a0 + v_c * a1 + w_c * a2  # (chunk, 16)

        onehot_o = (obj_c[:, None] == jnp.arange(O, dtype=jnp.int32)[None, :]).astype(dt)
        # f32 attrs (cfg.shade_f32) read the f32 L2W shadow — a dtype
        # matrix would re-quantize the world transform itself
        l2w_tab = frame.obj_l2w_f32 if dt == jnp.float32 else frame.obj_l2w
        l2w = jnp.dot(
            onehot_o, l2w_tab.reshape(O, 16), preferred_element_type=jnp.float32
        ).astype(dt).reshape(-1, 4, 4)
        # material ids ride the one-hot matmul in f32, NOT the render dtype:
        # bf16 represents integers exactly only up to 256, so ids above that
        # would quantize to a NEIGHBORING material before the matmul
        mat = jnp.dot(
            onehot_o.astype(jnp.float32),
            frame.obj_material.astype(jnp.float32)[:, None],
            preferred_element_type=jnp.float32,
        )[:, 0].astype(jnp.int32)
        return attr, l2w, mat

    tri = jnp.maximum(hit.tri, 0)
    obj = jnp.maximum(hit.obj, 0)
    if R <= chunk:
        attr, l2w, material = interp_chunk((tri, obj, u, v, w))
    else:
        pad = (-R) % chunk
        pz = lambda x: jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        nc = (R + pad) // chunk
        parts = jax.lax.map(
            interp_chunk,
            (
                pz(tri).reshape(nc, chunk),
                pz(obj).reshape(nc, chunk),
                pz(u).reshape(nc, chunk, 1),
                pz(v).reshape(nc, chunk, 1),
                pz(w).reshape(nc, chunk, 1),
            ),
        )
        attr = parts[0].reshape(-1, 16)[:R]
        l2w = parts[1].reshape(-1, 4, 4)[:R]
        material = parts[2].reshape(-1)[:R]

    position = attr[:, 0:3]
    normal = normalize(attr[:, 3:6])
    tangent = normalize(attr[:, 6:9])
    color = attr[:, 9:12]
    uv0 = attr[:, 12:14]
    uv1 = attr[:, 14:16]
    pos_w, normal, tangent = _finish_world(l2w, position, normal, tangent)
    return dict(
        position=pos_w,
        normal=normal,
        tangent=tangent,
        color=color,
        uv0=uv0,
        uv1=uv1,
        material=material,
        obj=hit.obj,
        tri=hit.tri,
    )


def _interpolate_gather(scene, frame, hit: Hit, dtype):
    dt = dtype
    tri = jnp.maximum(hit.tri, 0)
    obj = jnp.maximum(hit.obj, 0)
    idx = jnp.take(scene.tri_idx, tri, axis=0, mode="clip")  # (R, 3)

    u = hit.u.astype(dt)[..., None]
    v = hit.v.astype(dt)[..., None]
    w = (1.0 - hit.u - hit.v).astype(dt)[..., None]

    def lerp(attr):
        a0 = jnp.take(attr, idx[..., 0], axis=0, mode="clip")
        a1 = jnp.take(attr, idx[..., 1], axis=0, mode="clip")
        a2 = jnp.take(attr, idx[..., 2], axis=0, mode="clip")
        return (u * a0 + v * a1 + w * a2).astype(dt)

    position = lerp(scene.v_pos)
    normal = normalize(lerp(scene.v_normal))
    tangent = normalize(lerp(scene.v_tangent))
    color = lerp(scene.v_color)
    uv0 = lerp(scene.v_uv0)
    uv1 = lerp(scene.v_uv1)

    l2w_tab = frame.obj_l2w_f32 if dt == jnp.float32 else frame.obj_l2w
    l2w = jnp.take(l2w_tab, obj, axis=0, mode="clip")  # (R, 4, 4)
    pos_w, normal, tangent = _finish_world(l2w, position, normal, tangent)
    material = jnp.take(frame.obj_material, obj, mode="clip")
    return dict(
        position=pos_w,
        normal=normal,
        tangent=tangent,
        color=color,
        uv0=uv0,
        uv1=uv1,
        material=material,
        obj=hit.obj,
        tri=hit.tri,
    )


def fill_gbuffer(scene, frame, origins, directions, prec: Precision, *, cfg: RenderConfig):
    """Trace primary rays and produce the G-buffer pixel arrays.

    origins/directions: (R, 3) dtype.  Returns dict with `valid` mask plus
    the interpolated surface attributes (zeros on miss, like the reference's
    zero-fill, `rt/rtrt/cuda.hpp:1003-1011`) and `depth` (clip-space w aka
    ray t; the reference packs clip depth into normal_depth.w — we store the
    world-space hit distance which feeds SVGF's depth gradients).
    """
    hit = trace(scene, frame, origins, directions, prec=prec, cfg=cfg)
    # under cfg.shade_f32 the G-buffer attributes interpolate in f32 (the
    # one-hot matmuls accumulate in f32 anyway — this just skips the dtype
    # round-trip that quantizes normals/colors before shading)
    attr_dt = jnp.float32 if cfg.shade_f32 else prec.dtype
    attrs = interpolate_hit_attributes(scene, frame, hit, attr_dt)
    valid = hit.tri >= 0
    vz = valid[..., None]
    zero3 = jnp.zeros_like(attrs["position"])
    g = dict(
        valid=valid,
        position=jnp.where(vz, attrs["position"], zero3),
        normal=jnp.where(vz, attrs["normal"], zero3),
        tangent=jnp.where(vz, attrs["tangent"], zero3),
        color=jnp.where(vz, attrs["color"], zero3),
        uv0=jnp.where(vz, attrs["uv0"], jnp.zeros_like(attrs["uv0"])),
        uv1=jnp.where(vz, attrs["uv1"], jnp.zeros_like(attrs["uv1"])),
        obj=jnp.where(valid, hit.obj, 0),
        tri=jnp.where(valid, hit.tri, 0),
        material=jnp.where(valid, attrs["material"], 0),
        # depth is a FILTER CONTROL value (SVGF's edge-stopping weight and
        # its gradients — bf16 depth differences cancel catastrophically at
        # an 8-bit mantissa), so under shade_f32 it stays f32 like normal;
        # the raw f32 t rides separately for position reconstruction
        depth=jnp.where(valid, hit.t, 0.0).astype(attr_dt),
        t=hit.t,
    )
    return g, hit
