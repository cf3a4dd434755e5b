"""Texture sampling from the flat atlas.

Replaces CUDA texture objects (`RDTexture`, `rt/rtrt/memory.hpp:334-369`:
pitch-2D, normalized float reads, bilinear filter, wrap addressing, optional
sRGB) with manual bilinear gathers from the concatenated atlas
(SURVEY.md §7 hard part #4).
"""

from __future__ import annotations

import jax.numpy as jnp

from low_precision_raytracer.ops.sampling import direction_to_spherical


def _srgb_to_linear(c):
    """IEC 61966-2-1 decode (what cudaTextureDesc.sRGB applies on read)."""
    return jnp.where(
        c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4
    )


def sample_texture(scene, tex_id, uv):
    """Bilinear wrap-addressed fetch -> (..., 4) fp32 in [0, 1].

    tex_id: (...,) i32 atlas texture ids (callers mask id < 0 themselves).
    uv: (..., 2) any float dtype, normalized coords.
    """
    f32 = jnp.float32
    tid = jnp.maximum(tex_id, 0)
    w = jnp.take(scene.tex_width, tid, mode="clip")
    h = jnp.take(scene.tex_height, tid, mode="clip")
    off = jnp.take(scene.tex_offset, tid, mode="clip")
    srgb = jnp.take(scene.tex_srgb, tid, mode="clip")

    u = uv[..., 0].astype(f32) * w - 0.5
    v = uv[..., 1].astype(f32) * h - 0.5
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fu = u - x0
    fv = v - y0

    def texel(xi, yi):
        xi = jnp.mod(xi.astype(jnp.int32), w)
        yi = jnp.mod(yi.astype(jnp.int32), h)
        idx = off + yi * w + xi
        raw = jnp.take(scene.tex_data, idx, axis=0, mode="clip").astype(f32) / 255.0
        # decode EACH texel to linear BEFORE the bilinear blend — exactly
        # what cudaTextureDesc.sRGB does on read in the reference; blending
        # raw sRGB then decoding darkens filtered regions (0-and-1 neighbours
        # average to linear 0.5 there, 0.21 the wrong way)
        rgb = jnp.where(srgb[..., None], _srgb_to_linear(raw[..., :3]), raw[..., :3])
        return jnp.concatenate([rgb, raw[..., 3:4]], axis=-1)

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    top = c00 * (1 - fu)[..., None] + c10 * fu[..., None]
    bot = c01 * (1 - fu)[..., None] + c11 * fu[..., None]
    return top * (1 - fv)[..., None] + bot * fv[..., None]


def sample_skybox(scene, frame, directions):
    """Equirectangular HDR skybox fetch (`rt/rtrt/cuda.hpp:1786-1795`):
    bilinear wrap over the panorama, scaled by exposure.

    ONE flat take of the quad-packed footprint table (scene.sky_quad: the
    base texel's 2x2 neighborhood, wrap/clamp pre-applied) replaces four
    separate texel gathers.  Rows are split into <=32-byte channel groups
    (fp32 rows are 48B).

    Accepted deviations from the per-texel reference fetch (goldens were
    regenerated over both): (1) at the panorama poles (y0 = -1 or H-1, the
    top/bottom half-pixel) the quad table's y+1 taps at the clamped base row
    blend the adjacent row with weight >= 0.5 where the reference clamped
    both rows to the pole row; (2) quad texels are stored in the render
    dtype, so bf16 runs quantize HDR radiance that the reference fetched in
    f32 — within the precision policy's intent (radiance math is
    render-dtype everywhere else too).

    directions: (..., 3) -> (..., 3) fp32 radiance.
    """
    f32 = jnp.float32
    H, W = scene.sky_data.shape[0], scene.sky_data.shape[1]
    u, v = direction_to_spherical(directions, frame.sky_delta_x, frame.sky_delta_y)
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fu = (x - x0)[..., None]
    fv = (y - y0)[..., None]

    xi = jnp.mod(x0.astype(jnp.int32), W)
    yi = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    idx = (yi * W + xi).reshape(-1)
    quad = scene.sky_quad  # (H*W, 12) render dtype
    # channel groups: bf16 rows are 24B (one take); f32 rows split in two
    gsz = 12 if quad.dtype.itemsize <= 2 else 6
    parts = []
    for c0 in range(0, 12, gsz):
        parts.append(jnp.take(quad[:, c0 : c0 + gsz], idx, axis=0, mode="clip"))
    taps = jnp.concatenate(parts, axis=-1).reshape(directions.shape[:-1] + (4, 3)).astype(f32)
    c00, c10, c01, c11 = taps[..., 0, :], taps[..., 1, :], taps[..., 2, :], taps[..., 3, :]
    out = (c00 * (1 - fu) + c10 * fu) * (1 - fv) + (c01 * (1 - fu) + c11 * fu) * fv
    return out * frame.sky_exposure
