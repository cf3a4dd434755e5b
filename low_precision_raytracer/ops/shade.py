"""The shade stage (`shade<DataT, MAX_DIRECT_LIGHT, FIRST_ROUND, NO_GI>`,
`rt/rtrt/cuda.hpp:1751-2056`).

Pure function over SoA pixel arrays: consumes a ShadeInput (either the
G-buffer on the first round or the bounce shade-commands), emits
- per-round emission/ambient intensity,
- the GI bounce ray + its BRDF multiplier (with the NaN demodulation tag on
  round 0, `rt/rtrt/cuda.hpp:1917-1919`),
- up to MAX_DIRECT_LIGHT shadow-ray commands with premultiplied
  BRDF*cos*intensity/r^2 (`:2009-2055` — including the reference's /10
  point-light scaling quirk),
- the skybox radiance for empty/skybox pixels into DI slot 0.

Template flags become static Python branches; curand becomes jax.random
fields drawn per stage.  All shading math runs in the render dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from low_precision_raytracer.config import SKYBOX_COLOR, Precision, RenderConfig
from low_precision_raytracer.math.vec import dot, normalize, reflect
from low_precision_raytracer.models.hierarchy import LIGHT_DIRECTIONAL
from low_precision_raytracer.ops.bsdf import glassy_brdf, material_brdf
from low_precision_raytracer.ops.sampling import (
    pdf_ggx_reflect,
    sample_ggx,
    tangent_to_world,
    uniform_hemisphere_trig,
)
from low_precision_raytracer.ops.texture import sample_skybox, sample_texture

SHADE_INVALID = 0
SHADE_COMMON = 1
SHADE_SKYBOX = 2


class ShadeInput(NamedTuple):
    """`PixelShaderInput` (`rt/rtrt/cuda.hpp:1034-1048`) as SoA arrays."""

    type: jnp.ndarray  # (R,) i32
    position: jnp.ndarray  # (R, 3) dtype
    normal: jnp.ndarray
    tangent: jnp.ndarray
    color: jnp.ndarray  # vertex color
    uv0: jnp.ndarray
    uv1: jnp.ndarray
    material: jnp.ndarray  # (R,) i32
    obj: jnp.ndarray  # (R,) i32 inscene object id
    tri: jnp.ndarray  # (R,) i32 global triangle id
    # f32 hit position o32 + t * d32 (t is always f32) — the LIGHT-GEOMETRY
    # precision anchor in low-precision modes.  Deliberate deviation from
    # the reference (which shades entirely in DataT): a dtype position
    # wobbles the shadow-ray origin by |p| * 2^-9 ≈ 0.02 scene units in
    # bf16, which displaces contact-shadow boundaries by whole pixels, and
    # a dtype 1/dist^2 falloff bands the light attenuation into visible
    # contour rings.
    # None -> position.astype(f32) (fp32 mode: exact no-op).
    position_f32: jnp.ndarray | None = None


class LightCommands(NamedTuple):
    """`TraceLightCommand` SoA (`rt/rtrt/cuda.hpp:1023-1032`)."""

    valid: jnp.ndarray  # (R, L) bool (slot != UINT8_MAX)
    direction: jnp.ndarray  # (R, L, 3)
    max_t: jnp.ndarray  # (R, L)
    multiplier: jnp.ndarray  # (R, L, 3)


class ShadeOutputs(NamedTuple):
    intensity: jnp.ndarray  # (R, 3) emission/ambient for this round
    di_sky: jnp.ndarray  # (R, 3) skybox radiance -> DI slot 0
    albedo: jnp.ndarray  # (R, 3) (first round; zeros otherwise)
    lights: LightCommands
    gi_valid: jnp.ndarray  # (R,)
    gi_direction: jnp.ndarray  # (R, 3)
    gi_multiplier: jnp.ndarray  # (R, 3) (NaN tag in [2] on first round)
    view_dir_out: jnp.ndarray  # (R, 3) = -gi_direction
    skip_tri: jnp.ndarray  # (R,) i32
    source: jnp.ndarray  # (R, 3) ray origin for both command kinds


def gbuffer_to_shade_input(g, position_f32=None) -> ShadeInput:
    return ShadeInput(
        type=jnp.where(g["valid"], SHADE_COMMON, SHADE_INVALID).astype(jnp.int32),
        position=g["position"],
        position_f32=position_f32,
        normal=g["normal"],
        tangent=g["tangent"],
        color=g["color"],
        uv0=g["uv0"],
        uv1=g["uv1"],
        material=g["material"],
        obj=g["obj"],
        tri=g["tri"],
    )


def _gather_material(scene, mid):
    M = scene.mat_color.shape[0]
    if M <= 1024:
        # one-hot matmul gather: (R, M) @ (M, 11) in place of per-field
        # scalar gathers (see ops/gbuffer.py one-hot interpolation)
        f32 = jnp.float32
        table = jnp.concatenate(
            [
                scene.mat_color.astype(f32),
                scene.mat_emission.astype(f32),
                scene.mat_metallic.astype(f32)[:, None],
                scene.mat_roughness.astype(f32)[:, None],
                scene.mat_double_sided.astype(f32)[:, None],
                scene.mat_tex_color.astype(f32)[:, None],
                scene.mat_uv_color.astype(f32)[:, None],
            ],
            axis=1,
        )  # (M, 11)
        onehot = (mid[:, None] == jnp.arange(M, dtype=jnp.int32)[None, :]).astype(f32)
        g = jnp.dot(onehot, table, preferred_element_type=f32)
        dt = scene.mat_color.dtype
        return dict(
            color=g[:, 0:3].astype(dt),
            emission=g[:, 3:6].astype(dt),
            metallic=g[:, 6].astype(dt),
            roughness=g[:, 7].astype(dt),
            double_sided=g[:, 8] > 0.5,
            tex_color=g[:, 9].astype(jnp.int32),
            uv_color=g[:, 10].astype(jnp.int32),
        )
    take = lambda a: jnp.take(a, mid, axis=0, mode="clip")
    return dict(
        color=take(scene.mat_color),
        emission=take(scene.mat_emission),
        metallic=take(scene.mat_metallic),
        roughness=take(scene.mat_roughness),
        double_sided=take(scene.mat_double_sided),
        tex_color=take(scene.mat_tex_color),
        uv_color=take(scene.mat_uv_color),
    )


def shade(
    scene,
    frame,
    sinput: ShadeInput,
    view_dir,
    *,
    prec: Precision,
    cfg: RenderConfig,
    first_round: bool,
    no_gi: bool,
    key,
) -> ShadeOutputs:
    """One shade pass over R pixels.

    view_dir: (R, 3) dtype — the primary -ray direction on the first round
    (`settings.get_primary_ray_direction`, negated) or the carried
    `buffer.view_direction` on bounce rounds.
    """
    # cfg.shade_f32 (default): SHADING computes in f32 even in bf16/fp16
    # modes — shading error is systematic and survives any amount of
    # temporal accumulation (see config.RenderConfig.shade_f32).  The
    # inputs upcast exactly, and the RNG draws are made in this shade
    # dtype too.
    dt = jnp.float32 if cfg.shade_f32 else prec.dtype
    if sinput.position.dtype != dt:
        up = lambda x: x.astype(dt)
        sinput = sinput._replace(
            position=up(sinput.position), normal=up(sinput.normal),
            tangent=up(sinput.tangent), color=up(sinput.color),
            uv0=up(sinput.uv0), uv1=up(sinput.uv1),
        )
    if view_dir.dtype != dt:
        view_dir = view_dir.astype(dt)
    R = sinput.position.shape[0]
    zero3 = jnp.zeros((R, 3), dt)
    # only the scene's real light count is traced (static, see FrameInput)
    L = min(frame.n_lights, cfg.max_direct_lights)

    is_common = sinput.type == SHADE_COMMON
    is_skybox = sinput.type == SHADE_SKYBOX

    # ---- skybox radiance for empty/skybox pixels -> DI slot 0
    # first round: primary direction (`rt/rtrt/cuda.hpp:1786-1795`);
    # bounce: the GI ray direction = -view_direction (`:1828-1833`)
    di_sky = zero3
    if scene.sky_valid:
        sky_dir = -normalize(view_dir) if not first_round else -view_dir
        sky_rgb = sample_skybox(scene, frame, sky_dir).astype(dt)
        sky_mask = is_skybox if not first_round else (sinput.type == SHADE_INVALID)
        di_sky = jnp.where(sky_mask[:, None], sky_rgb, zero3)

    mat = _gather_material(scene, sinput.material)
    if mat["color"].dtype != dt:
        # material values upcast to the shade compute dtype (the gather's
        # one-hot matmul accumulated in f32 anyway)
        for k in ("color", "emission", "metallic", "roughness"):
            mat[k] = mat[k].astype(dt)

    # ---- base colour: texture x vertex colour (`rt/rtrt/cuda.hpp:1849-1856`)
    color = mat["color"]
    if scene.tex_data.shape[0] > 1:  # static: scene actually has textures
        has_tex = mat["tex_color"] >= 0
        tex_uv = jnp.where(
            (mat["uv_color"] == 0)[:, None], sinput.uv0, sinput.uv1
        )
        tex_rgba = sample_texture(scene, mat["tex_color"], tex_uv)
        color = jnp.where(has_tex[:, None], tex_rgba[..., :3].astype(dt), color)
    color = (color * sinput.color).astype(dt)

    # ---- N, V; double-sided flip or reject (`rt/rtrt/cuda.hpp:1869-1879`)
    raw_normal = sinput.normal
    v_dot_n = dot(view_dir, raw_normal)
    flip = (v_dot_n < 0) & mat["double_sided"]
    rejected = (v_dot_n < 0) & ~mat["double_sided"]
    normal = jnp.where(flip[:, None], -raw_normal, raw_normal)
    valid = is_common & ~rejected

    # ---- tangent frame re-orthogonalization (`rt/rtrt/cuda.hpp:1881-1887`)
    bitangent = normalize(jnp.cross(raw_normal, sinput.tangent))
    tangent = normalize(jnp.cross(bitangent, raw_normal))

    # ---- emission (overridden by the NO_GI fake ambient, `:2001-2006`)
    if no_gi:
        skyc = jnp.asarray(SKYBOX_COLOR, dt)
        intensity = skyc * color * jnp.asarray(0.5, dt)
    else:
        intensity = mat["emission"]
    intensity = jnp.where(valid[:, None], intensity, zero3)

    albedo = jnp.where(valid[:, None], color, zero3) if first_round else zero3

    # ---- GI ray generation (`rt/rtrt/cuda.hpp:1898-1999`)
    if not no_gi:
        # ONE batched draw: 7 separate threefry chains would each pay the
        # generator's setup, and `normal()` draws pay erfinv and 1.5x the
        # bits — so everything is uniforms, ONE flat draw, sliced
        # contiguously (a (R, 9) draw would put the small axis last).
        # Uniforms are drawn in the SHADE dtype (f32 under cfg.shade_f32):
        # a bf16 draw puts the sampled hemisphere on a ~2^-8 grid — a
        # quadrature bias no accumulation removes — and decorrelates the
        # bf16 path tree from the fp32 pipeline's (same key, different
        # values), which is most of the 8-frame ground-truth delta.  The
        # reference casts curand's f32 draws to DataT
        # (`rt/rtrt/cuda.hpp:1714-1717, 1906`); keeping them f32 is part of
        # this repo's low-precision boundary (intersection in bf16,
        # light-transport control values in f32).
        us = jax.random.uniform(key, (7 * R,), dt)
        (r_mirror, r_spec, r_metal, u_ggx1, u_ggx2, uh1, uh2) = (
            jax.lax.slice(us, (i * R,), ((i + 1) * R,)) for i in range(7)
        )

        metallic = mat["metallic"]
        roughness = mat["roughness"]
        one = jnp.asarray(1.0, dt)

        mirror_dir = normalize(reflect(view_dir, normal))

        lo_rough = roughness < jnp.asarray(0.1, dt)

        # ONE cosine-free hemisphere draw serves both roughness branches:
        # each ray takes exactly one branch, so sharing the uniforms is
        # statistically identical to the reference's two per-branch draws
        # (`rt/rtrt/cuda.hpp:1951-1996`) while halving the trig chains
        diff_dir, cos_diff = uniform_hemisphere_trig(
            normal, tangent, bitangent, uh1, uh2
        )

        # --- low-roughness lobes (roughness < 0.1)
        # (a) metallic russian-roulette mirror: multiplier includes base colour
        #     directly even on round 0 (no demodulation tag, `:1905-1920`)
        g_mirror = glassy_brdf(metallic, view_dir, mirror_dir, normal)
        mult_a = g_mirror.get_brdf(color) / metallic[:, None]
        # (b) glassy specular at p = 0.6
        pdf_b = (one - metallic) * jnp.asarray(0.6, dt)

        take_a = r_mirror < metallic
        take_b = ~take_a & (r_spec < jnp.asarray(0.6, dt))

        # --- high-roughness lobes (GGX importance / uniform hemisphere mix)
        a = roughness * roughness
        a2 = a * a
        h_t = sample_ggx(a2, u_ggx1, u_ggx2)
        h_w = normalize(tangent_to_world(h_t, normal, tangent, bitangent))
        ggx_dir = reflect(view_dir, h_w)
        ggx_cos = jnp.maximum(jnp.asarray(0.05, dt), dot(ggx_dir, h_w))
        pdf_ggx = pdf_ggx_reflect(h_t[..., 2], a2) * metallic / (4 * ggx_cos)
        pdf_diff = jnp.asarray(0.5 / jnp.pi, dt) * (one - metallic)

        take_ggx = r_metal < metallic
        dir_hi = normalize(jnp.where(take_ggx[:, None], ggx_dir, diff_dir))
        cos_sel = jnp.where(take_ggx, ggx_cos, cos_diff)
        pdf_sel = jnp.where(take_ggx, pdf_ggx, pdf_diff)

        # ONE shared material_brdf chain: the low branch only reads it at
        # the diffuse direction (its mirror/glassy lobes use glassy_brdf),
        # the high branch at dir_hi — disjoint per ray, so evaluate once at
        # the per-ray selected direction
        eval_dir = jnp.where(lo_rough[:, None], diff_dir, dir_hi)
        brdf_e = material_brdf(metallic, roughness, view_dir, eval_dir, normal)

        # REFERENCE QUIRK (`rt/rtrt/cuda.hpp:1926-1949`): the low-roughness
        # hemisphere lobe's multiplier is cosine * 2pi = cos/pdf_hemisphere
        # WITHOUT the 0.4*(1-metallic) lobe-selection probability that the
        # high-roughness branch folds into pdf_diff — the reference's own
        # estimator is inconsistent across its roughness<0.1 threshold and
        # we reproduce it exactly (parity over unbiasedness)
        mult_c_scalar = cos_diff * jnp.asarray(2.0 * jnp.pi, dt)
        mult_hi_scalar = cos_sel / pdf_sel
        # low-branch lobe-c and the whole high branch share the BRDF value;
        # only the scalar in front differs
        e_scalar = jnp.where(lo_rough, mult_c_scalar, mult_hi_scalar)
        if first_round:
            mult_b = jnp.stack(
                [g_mirror.colored / pdf_b, g_mirror.white / pdf_b, jnp.full((R,), jnp.nan, dt)],
                axis=-1,
            )
            mult_e = jnp.stack(
                [brdf_e.colored * e_scalar, brdf_e.white * e_scalar, jnp.full((R,), jnp.nan, dt)],
                axis=-1,
            )
        else:
            mult_b = g_mirror.get_brdf(color) / pdf_b[:, None]
            mult_e = brdf_e.get_brdf(color) * e_scalar[:, None]

        dir_lo = jnp.where(
            take_a[:, None] | take_b[:, None], mirror_dir, diff_dir
        )
        mult_lo = jnp.where(
            take_a[:, None], mult_a, jnp.where(take_b[:, None], mult_b, mult_e)
        )

        gi_direction = jnp.where(lo_rough[:, None], dir_lo, dir_hi)
        gi_multiplier = jnp.where(lo_rough[:, None], mult_lo, mult_e)
        gi_valid = valid
        gi_multiplier = jnp.where(valid[:, None], gi_multiplier, zero3)
    else:
        gi_direction = jnp.broadcast_to(jnp.asarray([0, 0, 1], dt), (R, 3))
        gi_multiplier = zero3
        gi_valid = jnp.zeros((R,), jnp.bool_)

    view_dir_out = -gi_direction

    # ---- direct-light commands (`rt/rtrt/cuda.hpp:2009-2055`).
    # LIGHT GEOMETRY runs in f32 from the f32 hit position (see
    # ShadeInput.position_f32): direction, distance falloff, cosine, and
    # range are precision-critical control values (a bf16 1/dist^2 bands
    # the falloff into contour rings; a bf16 origin displaces shadow
    # boundaries).  The BRDF itself stays in the render dtype — that IS
    # the low-precision claim.  In fp32 mode every line is bitwise the
    # dtype form.
    f32 = jnp.float32
    pos32 = (
        sinput.position_f32
        if sinput.position_f32 is not None
        else sinput.position.astype(f32)
    )
    n32 = normal.astype(f32)
    l_valid, l_dir, l_maxt, l_mult = [], [], [], []
    rough_di = jnp.maximum(mat["roughness"], jnp.asarray(0.10, dt))
    for i in range(L):
        lt = frame.light_type[i]
        lpos = frame.light_pos[i].astype(f32)
        ldirw = frame.light_dir[i].astype(f32)
        lint = frame.light_intensity[i].astype(f32)
        lv = frame.light_valid[i]

        is_dir = lt == LIGHT_DIRECTIONAL
        # point/spot path
        dvec = lpos - pos32
        dist2 = dot(dvec, dvec)
        pdir = normalize(dvec)
        # directional path
        ddir = -normalize(ldirw)
        ldir_i = jnp.where(is_dir, ddir, pdir)
        cosine = dot(ldir_i, n32)

        # the DI BRDF chain also runs f32: direct lighting is DETERMINISTIC
        # (no Monte-Carlo averaging can wash its rounding out), and the
        # ~15-op dtype chain costs ~1% relative error — the densest term of
        # the measured bf16-vs-fp32 DI gap.  GI lobe generation stays in
        # the render dtype (unbiased sampling noise dominates there).
        b32 = material_brdf(
            mat["metallic"].astype(f32), rough_di.astype(f32),
            view_dir.astype(f32), ldir_i, n32
        ).get_brdf(color.astype(f32))
        point_mult = (cosine / dist2 / jnp.asarray(10.0, f32))[:, None] * b32 * lint
        dir_mult = cosine[:, None] * b32 * lint
        mult_i = jnp.where(is_dir, dir_mult, point_mult)
        maxt_i = jnp.where(is_dir, jnp.asarray(1000.0, f32), jnp.sqrt(dist2))

        ok = valid & lv & (cosine >= 0)
        l_valid.append(ok)
        l_dir.append(jnp.where(ok[:, None], ldir_i, jnp.broadcast_to(jnp.asarray([0, 0, 1], f32), (R, 3))))
        l_maxt.append(jnp.where(ok, maxt_i, jnp.asarray(0.0, f32)))
        l_mult.append(jnp.where(ok[:, None], mult_i, jnp.zeros((R, 3), f32)))

    if L > 0:
        lights = LightCommands(
            valid=jnp.stack(l_valid, axis=1),
            direction=jnp.stack(l_dir, axis=1),
            max_t=jnp.stack(l_maxt, axis=1),
            multiplier=jnp.stack(l_mult, axis=1),
        )
    else:
        lights = LightCommands(
            valid=jnp.zeros((R, 0), jnp.bool_),
            direction=jnp.zeros((R, 0, 3), f32),
            max_t=jnp.zeros((R, 0), f32),
            multiplier=jnp.zeros((R, 0, 3), f32),
        )

    return ShadeOutputs(
        intensity=intensity,
        di_sky=di_sky,
        albedo=albedo,
        lights=lights,
        gi_valid=gi_valid,
        gi_direction=gi_direction,
        gi_multiplier=gi_multiplier,
        view_dir_out=view_dir_out,
        skip_tri=jnp.where(valid, sinput.tri, -1),
        # ray origins leave in f32; the trace quantises them to the render
        # dtype itself (the dtype-keyed ray_moveforward_t clears that)
        source=pos32,
    )
