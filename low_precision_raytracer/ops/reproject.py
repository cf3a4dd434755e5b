"""Temporal reprojection (`rt/rtrt/cuda.hpp:2230-2416`).

Reprojects each pixel: world position -> object local (current W2L) ->
last-frame world (stored per-mesh L2W) -> last-frame clip (stored W2C) ->
screen, then builds TWO 2x2 bilinear maps (SURVEY.md 2.18):
- the SVGF map, validated per tap by same-mesh-id with weight
  renormalization and frame-count propagation;
- the TAA map, with stochastically jittered bilinear taps and the
  same-object test only gating the frame count.

Formulation:
- the three per-pixel 4x4 matrix multiplies collapse into ONE per-object
  composite matrix applied via a one-hot matmul (a gather from a small
  table written as a matmul);
- a temporal map stores the 2x2 footprint as a single (base_y, base_x)
  anchor + 4 weights; every history fetch is ONE windowed `lax.gather`
  (slice_sizes=(2,2)) instead of four scalar gathers — 4x fewer gather
  indices, the dominant cost of this stage;
- map layout: {frame_count (H,W) i32, weights (H,W,4) dtype,
  base_y/base_x (H,W) i32 (pre-shifted for the +1 padding)} with tap order
  [(y0,x0), (y0,x1), (y1,x0), (y1,x1)].

Deviation: the reference increments the propagated SVGF frame count once per
*tap loop iteration* (up to +4/frame, `rt/rtrt/cuda.hpp:2330-2333`), which
reads like a typo for the SVGF paper's +1/frame; we increment once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp



RES_K = 1  # residual radius of the shifted-select fast path.  Static or
# translating cameras produce residuals in {-1, 0} (the trunc of the
# bilinear footprint), so K=1 covers the steady state with 9 shifts
# instead of 25 — the select loop is the fast path's whole cost.  Frames
# whose motion spreads residuals wider fall back to the take path.


def _gather2x2_take(a, base_y, base_x):
    """Quad-packed flat gather (the general path).

    The 4 bilinear taps of every anchor are first packed into ONE row of a
    shifted-slice tensor (cheap fused shifts, ~3.5 ms at 1080p), so a
    single `jnp.take` per channel group fetches the whole 2x2 footprint —
    4x fewer gather indices.  Channel groups are sized so a gathered row
    stays <= 32 bytes."""
    H, W = a.shape[:2]
    C = a.shape[2]
    ap = jnp.pad(a, ((1, 1), (1, 1), (0, 0)))
    # (H+1, W+1, 4, C): row (y, x) holds taps [(y,x), (y,x+1), (y+1,x),
    # (y+1,x+1)] of the padded array — exactly one 2x2 footprint
    quad = jnp.stack([ap[:-1, :-1], ap[:-1, 1:], ap[1:, :-1], ap[1:, 1:]], axis=2)
    idx = (base_y * (W + 1) + base_x).reshape(-1)
    gsz = max(1, 32 // (4 * a.dtype.itemsize))
    outs = []
    for c0 in range(0, C, gsz):
        c1 = min(c0 + gsz, C)
        g = quad[..., c0:c1].reshape((H + 1) * (W + 1), 4 * (c1 - c0))
        outs.append(jnp.take(g, idx, axis=0, mode="clip").reshape(H, W, 4, c1 - c0))
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)


def _gather2x2_shifted(a, base_y, base_x, my, mx, res_y, res_x):
    """Shifted-select fast path: every caring pixel's anchor is within
    RES_K of (pixel + global motion (my, mx)), so the whole tap fetch is
    (2K+1)^2 masked adds over statically shifted slices of the globally
    rolled history — zero gather indices.  The outer K-pad must WRAP: a
    caring border pixel whose slice index overflows Pr (e.g. bottom row,
    residual +1 under global motion my <= -2) still addresses a real row of
    the padded history — the roll correspondence puts it at the circularly
    wrapped index, so a wrap pad reads exactly P[base + tap] while a zero
    pad would silently return 0 there."""
    H, W = a.shape[:2]
    K = RES_K
    P = jnp.pad(a, ((1, 1), (1, 1), (0, 0)))  # (H+2, W+2, C)
    Pr = jnp.roll(P, shift=(-my, -mx), axis=(0, 1))
    E = jnp.pad(Pr, ((K, K), (K, K), (0, 0)), mode="wrap")
    view = lambda sy, sx: jax.lax.slice(
        E, (1 + K + sy, 1 + K + sx, 0), (1 + K + sy + H, 1 + K + sx + W, E.shape[2])
    )
    out = [jnp.zeros_like(a) for _ in range(4)]
    taps = ((0, 0), (0, 1), (1, 0), (1, 1))
    for sy in range(-K, K + 1):
        for sx in range(-K, K + 1):
            m = ((res_y == sy) & (res_x == sx))[..., None]
            for k, (dy, dx) in enumerate(taps):
                v = view(sy + dy, sx + dx)
                out[k] = out[k] + jnp.where(m, v, jnp.zeros_like(v))
    return jnp.stack(out, axis=2)  # (H, W, 4, C)


HALO_ROWS = 17  # multi-device vertical tap reach: 16 rows + 1 footprint row.
# Under a pixel-row mesh the tap fetch must not address arbitrary global
# rows (GSPMD lowers that to an all-gather of the whole history).  The halo path exchanges HALO_ROWS
# with each row-neighbour (2 ppermutes) and gathers locally;
# anchors further than the halo read zeros, which the validation channels
# turn into "no history" (temporal restart) — the multi-device policy for
# >16 px/frame vertical motion.  Horizontal motion is unlimited (the
# column axis is unsharded).


def _gather2x2_halo(a, base_y, base_x, mesh):
    """Shard-local 2x2 tap fetch under a pixel-row mesh.

    a: (H, W, C) row-sharded; base_*: (H, W) i32 pre-shifted global anchors
    (+1 pad convention of gather2x2).  -> (H, W, 4, C), tap order as
    _gather2x2_take.  Communication: exactly two ppermutes of HALO_ROWS
    rows; the take itself is device-local."""
    import jax

    axis = mesh.axis_names[0]
    n = int(mesh.devices.size)
    H, W = a.shape[:2]
    C = a.shape[2]

    def local(a_l, by_l, bx_l):
        i = jax.lax.axis_index(axis)
        Hl = a_l.shape[0]
        kh = min(HALO_ROWS, Hl)
        r0 = i * Hl
        fwd = [(j, (j + 1) % n) for j in range(n)]
        bwd = [(j, (j - 1) % n) for j in range(n)]
        from_prev = jax.lax.ppermute(a_l[Hl - kh :], axis, fwd)
        from_next = jax.lax.ppermute(a_l[:kh], axis, bwd)
        ext = jnp.concatenate([from_prev, a_l, from_next], axis=0)
        # zero rows that wrapped past the global image edge (and the
        # virtual -1 / H pad rows): zero taps read as mesh-id -1 /
        # frame-count 0 downstream, i.e. "no history" — identical to the
        # single-chip zero pad
        gr = r0 - kh + jnp.arange(Hl + 2 * kh, dtype=jnp.int32)
        ok_row = (gr >= 0) & (gr < H)
        ext = jnp.where(ok_row[:, None, None], ext, 0)
        extp = jnp.pad(ext, ((0, 1), (1, 1), (0, 0)))
        quad = jnp.stack(
            [extp[:-1, :-1], extp[:-1, 1:], extp[1:, :-1], extp[1:, 1:]],
            axis=2,
        )  # (Hl + 2kh, W + 1, 4, C)
        ly = by_l - 1 - r0 + kh  # padded-global anchor -> ext quad row
        reach = (ly >= 0) & (ly <= Hl + 2 * kh - 1)
        lyc = jnp.clip(ly, 0, Hl + 2 * kh - 1)
        idx = (lyc * (W + 1) + bx_l).reshape(-1)
        gsz = max(1, 32 // (4 * a_l.dtype.itemsize))
        rows = (Hl + 2 * kh) * (W + 1)
        outs = []
        for c0 in range(0, C, gsz):
            c1 = min(c0 + gsz, C)
            g = quad[..., c0:c1].reshape(rows, 4 * (c1 - c0))
            outs.append(
                jnp.take(g, idx, axis=0, mode="clip").reshape(Hl, W, 4, c1 - c0)
            )
        out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)
        return jnp.where(reach[..., None, None], out, 0)

    from jax.sharding import PartitionSpec as P

    row = P(axis)
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(row, row, row),
        out_specs=row,
        check_vma=False,
    )(a, base_y, base_x)


def _residuals(base_y, base_x, care):
    """Global integer motion estimate + per-pixel residuals of the anchor
    field: (my, mx, res_y, res_x, all_ok) where all_ok means every caring
    anchor sits within RES_K of pixel + (my, mx)."""
    H, W = base_y.shape
    row = jnp.arange(H, dtype=jnp.int32)[:, None]
    col = jnp.arange(W, dtype=jnp.int32)[None, :]
    dy = base_y - (row + 1)
    dx = base_x - (col + 1)
    cf = care.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(cf), 1.0)
    my = jnp.round(jnp.sum(dy * cf) / n).astype(jnp.int32)
    mx = jnp.round(jnp.sum(dx * cf) / n).astype(jnp.int32)
    res_y = dy - my
    res_x = dx - mx
    K = RES_K
    in_win = (jnp.abs(res_y) <= K) & (jnp.abs(res_x) <= K)
    all_ok = jnp.all(in_win | ~care)
    return my, mx, res_y, res_x, all_ok


def gather2x2(arr, base_y, base_x, care=None, mesh=None, residuals=None):
    """Fetch the 2x2 window anchored at (base_y, base_x) for every pixel.

    arr: (H, W) or (H, W, C); base_*: (H, W) i32 PRE-SHIFTED for a 1-pixel
    zero pad (i.e. already in [0, H] / [0, W]).
    -> (H, W, 4[, C]) in tap order [(0,0), (0,1), (1,0), (1,1)].

    `care` (optional (H, W) bool): pixels whose taps actually matter
    (valid g-buffer + at least one in-bounds tap).  When given, the fetch
    tests whether every caring anchor sits within RES_K pixels of the
    pixel + one global integer motion vector — true for the whole frame
    under static or smoothly moving cameras — and if so runs a zero-index
    shifted-select instead of the flat gather (`lax.cond` picks per
    frame; fast-moving content falls back to the general take path).

    `residuals`: optional precomputed _residuals(base_y, base_x, care)
    (shared between the validation fetch and the weighted payload fetch).

    `mesh` (optional jax.sharding.Mesh, pixel-row axis): route the fetch
    through the shard-local halo path (_gather2x2_halo) — bounded
    communication instead of GSPMD all-gathers."""
    chan = arr.ndim == 3
    a = arr if chan else arr[..., None]
    if mesh is not None and int(mesh.devices.size) > 1:
        out = _gather2x2_halo(a, base_y, base_x, mesh)
        return out if chan else out[..., 0]
    if care is None and residuals is None:
        out = _gather2x2_take(a, base_y, base_x)
        return out if chan else out[..., 0]

    my, mx, res_y, res_x, all_ok = (
        residuals if residuals is not None else _residuals(base_y, base_x, care)
    )
    out = jax.lax.cond(
        all_ok,
        lambda: _gather2x2_shifted(a, base_y, base_x, my, mx, res_y, res_x),
        lambda: _gather2x2_take(a, base_y, base_x),
    )
    return out if chan else out[..., 0]


def _fetch_weighted_shifted(a, wgt, my, mx, res_y, res_x):
    """Weighted 2x2 fetch on the shifted-select fast path, contracted over
    COEFFICIENT PLANES: the per-view coefficient coeff(v) = sum_k w_k *
    [res == v - tap_k] is channel-free, so the payload sees 16 fused
    multiply-adds total instead of 36 masked tap selects + a downstream
    4-tap weighted reduce — ~2.5x fewer (H, W, C) passes.
    -> num (H, W, C) f32 = sum_k w_k * tap_k (same pad/wrap semantics as
    _gather2x2_shifted + weights)."""
    H, W = a.shape[:2]
    K = RES_K
    f32 = jnp.float32
    P = jnp.pad(a, ((1, 1), (1, 1), (0, 0)))
    Pr = jnp.roll(P, shift=(-my, -mx), axis=(0, 1))
    E = jnp.pad(Pr, ((K, K), (K, K), (0, 0)), mode="wrap")
    view = lambda sy, sx: jax.lax.slice(
        E, (1 + K + sy, 1 + K + sx, 0), (1 + K + sy + H, 1 + K + sx + W, E.shape[2])
    )
    taps = ((0, 0), (0, 1), (1, 0), (1, 1))
    w32 = wgt.astype(f32)
    num = jnp.zeros((H, W, a.shape[2]), f32)
    for vy in range(-K, K + 2):
        for vx in range(-K, K + 2):
            coeff = None
            for k, (dy, dx) in enumerate(taps):
                sy, sx = vy - dy, vx - dx
                if -K <= sy <= K and -K <= sx <= K:
                    term = jnp.where(
                        (res_y == sy) & (res_x == sx), w32[..., k], 0.0
                    )
                    coeff = term if coeff is None else coeff + term
            if coeff is not None:
                num = num + coeff[..., None] * view(vy, vx).astype(f32)
    return num


def fetch_weighted(arr, base_y, base_x, wgt, residuals, mesh=None):
    """Weighted payload fetch: -> num (H, W, C) f32 = sum_k w_k * tap_k.
    Callers divide by den = sum_k w_k (and apply their validity default).
    Fast path = coefficient-plane contraction (_fetch_weighted_shifted);
    fallback/meshed paths weight the raw taps."""
    chan = arr.ndim == 3
    a = arr if chan else arr[..., None]
    w32 = wgt.astype(jnp.float32)

    def weight_raw(taps):
        return jnp.sum(taps.astype(jnp.float32) * w32[..., None], axis=2)

    if mesh is not None and int(mesh.devices.size) > 1:
        num = weight_raw(_gather2x2_halo(a, base_y, base_x, mesh))
        return num if chan else num[..., 0]
    assert residuals is not None, (
        "fetch_weighted needs residuals off the halo path — callers must "
        "normalize a 1-device mesh to None (generate_temporal_maps does)"
    )
    my, mx, res_y, res_x, all_ok = residuals
    num = jax.lax.cond(
        all_ok,
        lambda: _fetch_weighted_shifted(a, wgt, my, mx, res_y, res_x),
        lambda: weight_raw(_gather2x2_take(a, base_y, base_x)),
    )
    return num if chan else num[..., 0]


def gather_taps(tmap, arr):
    """Raw 2x2 tap fetch for a map: (H, W, 4[, C]).  Pack several history
    channels into one (H, W, C) array and gather ONCE."""
    return gather2x2(arr, tmap["base_y"], tmap["base_x"])


def weighted_taps(tmap, vals, default, channel: bool):
    """Finish a tap fetch: weighted mean over taps with frame_count gating
    (`sample_linear` semantics, `rt/rtrt/cuda.hpp:1085-1115`)."""
    wgt = tmap["weights"].astype(jnp.float32)
    v = vals.astype(jnp.float32)
    if channel:
        num = jnp.sum(v * wgt[..., None], axis=2)
        den = jnp.sum(wgt, axis=2)[..., None]
    else:
        num = jnp.sum(v * wgt, axis=2)
        den = jnp.sum(wgt, axis=2)
    out = num / den
    valid = tmap["frame_count"] > 0
    if channel:
        out = jnp.where(valid[..., None], out, jnp.asarray(default, jnp.float32))
    else:
        out = jnp.where(valid, out, jnp.asarray(default, jnp.float32))
    return out


def sample_linear(tmap, arr, default):
    """Weighted 2x2 history gather (`sample_linear`,
    `rt/rtrt/cuda.hpp:1085-1115`).  arr: (H, W) or (H, W, C)."""
    vals = gather_taps(tmap, arr)
    out = weighted_taps(tmap, vals, 0.0, channel=arr.ndim == 3)
    valid = tmap["frame_count"] > 0
    out = out.astype(arr.dtype)
    if arr.ndim == 3:
        return jnp.where(valid[..., None], out, default)
    return jnp.where(valid, out, default)


def _footprint(fx, fy, H, W, dt):
    """2x2 bilinear footprint: anchor (trunc toward zero, like the
    reference's (int) cast `rt/rtrt/cuda.hpp:2310-2313`), per-tap weights in
    window order, and per-tap in-bounds masks."""
    lx = jnp.trunc(fx)
    ly = jnp.trunc(fy)
    wx1 = (fx - lx).astype(dt)  # weight of x1 tap
    wy1 = (fy - ly).astype(dt)
    wx0 = ((lx + 1) - fx).astype(dt)
    wy0 = ((ly + 1) - fy).astype(dt)
    w = jnp.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], axis=-1)

    lyi = ly.astype(jnp.int32)
    lxi = lx.astype(jnp.int32)
    y0_ok = (lyi >= 0) & (lyi < H)
    y1_ok = (lyi + 1 >= 0) & (lyi + 1 < H)
    x0_ok = (lxi >= 0) & (lxi < W)
    x1_ok = (lxi + 1 >= 0) & (lxi + 1 < W)
    inb = jnp.stack(
        [y0_ok & x0_ok, y0_ok & x1_ok, y1_ok & x0_ok, y1_ok & x1_ok], axis=-1
    )
    # pre-shifted anchors for the +1 pad; clip so the window stays in range
    base_y = jnp.clip(lyi + 1, 0, H)
    base_x = jnp.clip(lxi + 1, 0, W)
    # taps whose true position was clipped away must not contribute
    inb = inb & (lyi + 1 == base_y)[..., None] & (lxi + 1 == base_x)[..., None]
    return base_y, base_x, w, inb


def generate_temporal_maps(g, frame, state, width: int, height: int, dtype, key,
                           svgf_payload=None, taa_payload=None,
                           n_meshes: int | None = None, position_f32=None,
                           mesh=None, want_taa: bool = True):
    """`generate_temporal_map_step1/2` (`rt/rtrt/cuda.hpp:2265-2416`).
    -> (svgf_map, taa_map, svgf_taps, taa_taps).

    `want_taa=False` skips the TAA half entirely (jitter RNG draw, second
    footprint, its validation gather and payload fetch) and returns
    (svgf_map, None, svgf_taps, None).  Used when the TAA blend is the
    exact identity (mix weight 1, the reference's default — see
    render/renderer.py) so its map would be dead code XLA cannot prove
    dead (it can't rule out non-finite history, so `hist * 0` doesn't
    fold).

    svgf_payload/taa_payload: optional (H, W, C) history channels; their
    FINISHED weighted fetches are returned as (H, W, C) f32 (or None):
    per-pixel sum_k w_k * tap_k / sum_k w_k with the map's frame-count
    gating already applied (default 0).  Fetching payload AFTER the
    validation weights are known lets the fast path contract over
    channel-free coefficient planes (fetch_weighted) instead of gathering
    raw 4-tap sets — consumers skip their weighted_taps reduce entirely.

    With `n_meshes` <= 254 (static), the per-tap validation data — mesh id
    and SVGF frame count, both small integers that bf16 represents exactly —
    packs into bf16 channels; otherwise both pack into one f32 channel:
    (mesh+1) * 512 + count stays < 2^24, exact in f32."""
    dt = dtype
    H, W = height, width
    # a 1-device mesh is semantically no mesh: the halo-exchange gathers
    # exist to bound cross-shard reads, and the residual fast path (which
    # this module disables under meshes) is both valid and faster there.
    # fetch_weighted's residual unpack also REQUIRES residuals when it
    # doesn't take the halo path, so the two conditions must agree.
    if mesh is not None and int(mesh.devices.size) == 1:
        mesh = None
    valid = g["valid"]
    fold = n_meshes is not None and n_meshes <= 254

    obj = g["obj"]
    mesh_p = jnp.take(frame.obj_mesh, obj, mode="clip")

    # one composite reprojection matrix per object, applied per pixel via a
    # one-hot matmul gather.  The whole matrix chain runs in fp32: a bf16
    # composite wobbles the reprojected footprint by several pixels at
    # 1080p, silently degrading history validation (the per-pixel cost is
    # one small O x 16 matmul — negligible).
    f32 = jnp.float32
    O = frame.obj_w2l.shape[0]
    comp = state.last_w2c[None] @ state.last_l2w @ frame.obj_w2l_f32
    onehot_o = (
        obj.reshape(-1)[:, None] == jnp.arange(O, dtype=jnp.int32)[None, :]
    ).astype(f32)
    comp_px = jnp.dot(
        onehot_o, comp.reshape(O, 16), preferred_element_type=f32
    ).reshape(H, W, 4, 4)

    # reproject an f32-reconstructed position when the caller provides one
    # (bf16 G-buffer positions scatter the footprint by pixels at 1080p,
    # which both degrades history validation and defeats the shifted-select
    # gather fast path)
    pos = (position_f32 if position_f32 is not None else g["position"]).astype(f32)
    p4 = jnp.concatenate([pos, jnp.ones((H, W, 1), f32)], axis=-1)
    clip = (comp_px @ p4[..., None])[..., 0]
    g_fx = (1 + clip[..., 0] / clip[..., 3]) / 2 * W
    g_fy = (1 + clip[..., 1] / clip[..., 3]) / 2 * H

    # last-frame validation data: (mesh+1) and the SVGF frame count.  When
    # folding, each rides as a payload channel (exact small integers in any
    # float dtype); otherwise both pack into one f32 channel gathered
    # separately: (mesh+1) * 512 + count stays < 2^24, exact in f32.
    mesh_ch = (state.last_mesh_id + 1).astype(jnp.float32)
    count_ch = jnp.clip(state.svgf_frame_count, 0, 255).astype(jnp.float32)
    packed_val = mesh_ch * 512 + count_ch

    def fetch_validation(by, bx, want_count, care, residuals):
        """-> (tap_mesh (H,W,4) i32, tap_count i32 | None)."""
        if fold:
            chans = [mesh_ch.astype(dt)[..., None]]
            if want_count:
                chans.append(count_ch.astype(dt)[..., None])
            taps = gather2x2(
                jnp.concatenate(chans, axis=-1), by, bx, care=care,
                mesh=mesh, residuals=residuals,
            ).astype(jnp.float32)
            tap_mesh = jnp.round(taps[..., 0]).astype(jnp.int32) - 1
            tap_count = (
                jnp.round(taps[..., 1]).astype(jnp.int32) if want_count else None
            )
            return tap_mesh, tap_count
        pk = jnp.round(
            gather2x2(packed_val, by, bx, care=care, mesh=mesh,
                      residuals=residuals)
        ).astype(jnp.int32)
        return pk // 512 - 1, pk % 512

    def fetch_payload(payload, by, bx, wgt, count, residuals):
        """Finished weighted fetch: (H, W, C) f32, 0 where no history."""
        if payload is None:
            return None
        num = fetch_weighted(payload, by, bx, wgt, residuals, mesh=mesh)
        den = jnp.sum(wgt.astype(jnp.float32), axis=-1)
        out = num / jnp.where(den > 0, den, 1.0)[..., None]
        return jnp.where((count > 0)[..., None], out, 0.0)

    # ---- SVGF map (strict same-object validation)
    by, bx, w, inb = _footprint(g_fx - jnp.asarray(0.5, dt), g_fy - jnp.asarray(0.5, dt), H, W, dt)
    care_s = valid & jnp.any(inb, axis=-1)
    res_s = None if mesh is not None else _residuals(by, bx, care_s)
    tap_mesh, tap_count = fetch_validation(by, bx, True, care_s, res_s)
    tap_ok = inb & (tap_mesh == mesh_p[..., None]) & valid[..., None]
    w_s = jnp.where(tap_ok, w, 0).astype(dt)
    total = jnp.sum(w_s, axis=-1)
    any_ok = total > 0
    w_s = jnp.where(any_ok[..., None], w_s / jnp.where(any_ok, total, 1)[..., None], 0)
    fc = jnp.max(jnp.where(tap_ok, tap_count, 0), axis=-1)
    new_count = jnp.where(any_ok & valid, jnp.minimum(fc + 1, 255), 0).astype(jnp.int32)
    svgf_map = dict(frame_count=new_count, weights=w_s, base_y=by, base_x=bx)
    svgf_pre = fetch_payload(svgf_payload, by, bx, w_s, new_count, res_s)

    if not want_taa:
        return svgf_map, None, svgf_pre, None

    # ---- TAA map (jittered bilinear, loose validation)
    # one bits draw, 16 bits per jitter axis (bf16 keeps ~8 of them anyway)
    bits = jax.random.bits(key, (H, W), jnp.uint32)
    jx = ((bits & 0xFFFF).astype(jnp.float32) * (1.0 / 65536.0)).astype(dt)
    jy = ((bits >> 16).astype(jnp.float32) * (1.0 / 65536.0)).astype(dt)
    by2, bx2, w2, inb2 = _footprint(g_fx - jx, g_fy - jy, H, W, dt)
    care_t = valid & jnp.any(inb2, axis=-1)
    res_t = None if mesh is not None else _residuals(by2, bx2, care_t)
    tap_mesh2, _ = fetch_validation(by2, bx2, False, care_t, res_t)
    w_t = jnp.where(inb2, w2, 0).astype(dt)
    total2 = jnp.sum(w_t, axis=-1)
    any2 = total2 > 0
    w_t = jnp.where(any2[..., None], w_t / jnp.where(any2, total2, 1)[..., None], 0)
    same_obj = jnp.any(inb2 & (tap_mesh2 == mesh_p[..., None]), axis=-1)
    taa_count = jnp.where(same_obj & valid & any2, 1, 0).astype(jnp.int32)
    taa_map = dict(frame_count=taa_count, weights=w_t, base_y=by2, base_x=bx2)
    taa_pre = fetch_payload(taa_payload, by2, bx2, w_t, taa_count, res_t)

    # the "Backup Temporal Data" stage (`copy_last_frame_pixel_id` +
    # `copy_last_frame_transform`, `rt/rtrt/cuda.hpp:2230-2263`) lives
    # inline in render_frame's FrameState construction (render/renderer.py)
    # — it is three field copies, not a kernel
    return svgf_map, taa_map, svgf_pre, taa_pre
