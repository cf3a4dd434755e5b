"""Auxiliary subsystems: controllers, checkpoint/resume, diagnostics,
temporal reprojection identity."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from low_precision_raytracer.config import RenderConfig, get_precision
from low_precision_raytracer.gui.controller import HoldRotateController, MoveController
from low_precision_raytracer.models.hierarchy import build_flat_scene
from low_precision_raytracer.models.procedural import cornell_box_scene
from low_precision_raytracer.models.scene import frame_input_from_flat
from low_precision_raytracer.ops.camera import primary_ray_grid
from low_precision_raytracer.ops.diagnostics import fallback_rate
from low_precision_raytracer.render.checkpoint import load_checkpoint, save_checkpoint
from low_precision_raytracer.render.framestate import init_frame_state


def test_move_controller_accelerates_and_clamps():
    c = MoveController(initial_speed=1.0, acceleration=10.0, max_speed=5.0, max_position=100.0)
    for _ in range(50):
        c.receive_event(0.1, True, False)
    assert c.accumulated_pos > 0
    assert abs(c._speed) <= 5.0 + 1e-9
    # releasing resets speed
    c.receive_event(0.1, False, False)
    assert c._speed == 0.0
    v = c.pop_value()
    assert v > 0 and c.get_value() == 0.0


def test_rotate_controller_drag_and_clamp():
    c = HoldRotateController()
    c.receive_event((0, 0), right_down=True)
    c.receive_event((100, 5000), right_down=True)
    assert c.acc_x != 0
    assert c.acc_y == c.y_max  # pitch clamped
    c.receive_event((100, 5000), right_down=False, wheel=100.0)
    assert c.acc_z == c.z_max  # fov clamped
    c.clear()
    assert c.acc_x == 0 and abs(c.acc_z - math.pi * 0.3) < 1e-9


def test_checkpoint_roundtrip(tmp_path):
    cfg = RenderConfig(width=16, height=16, precision="bf16")
    state = init_frame_state(cfg, n_objects=3)
    state = state._replace if hasattr(state, "_replace") else state
    import dataclasses

    state = dataclasses.replace(
        state, taa_history=jnp.full((16, 16, 3), 0.25, cfg.dtype)
    )
    key = jax.random.PRNGKey(42)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state, key, 7)
    s2, k2, fi = load_checkpoint(path)
    assert fi == 7
    np.testing.assert_array_equal(
        np.asarray(state.taa_history, np.float32), np.asarray(s2.taa_history, np.float32)
    )
    assert s2.last_l2w.shape == (3, 4, 4)
    # keys produce the same randomness
    a = jax.random.uniform(key, (4,))
    b = jax.random.uniform(k2, (4,))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_preserves_key_impl(tmp_path):
    """A typed rbg key has 4-word data; the checkpoint must
    round-trip its PRNG IMPLEMENTATION, not just its data — wrapping rbg
    data with the default threefry impl yields a wrong-shaped batched key
    that jax.random.split rejects."""
    cfg = RenderConfig(width=8, height=8, precision="bf16")
    state = init_frame_state(cfg, n_objects=1)
    key = jax.random.key(7, impl="rbg")
    path = str(tmp_path / "ck_rbg.npz")
    save_checkpoint(path, state, key, 2)
    _, k2, _ = load_checkpoint(path)
    assert str(jax.random.key_impl(k2)) == "rbg"
    assert k2.shape == ()  # scalar typed key, splittable
    jax.random.split(k2)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(k2)), np.asarray(jax.random.key_data(key))
    )


def test_fallback_rate_bf16_exceeds_fp32():
    """bf16's wider error bands must produce a higher fp32-fallback rate."""
    host = cornell_box_scene()
    rates = {}
    for name in ("fp32", "bf16"):
        prec = get_precision(name)
        flat = build_flat_scene(host.root, host.active_camera)
        frame = frame_input_from_flat(flat, host, prec)
        o, d = primary_ray_grid(frame.cam_l2w, flat.cam_fov_y, 24, 24, prec.dtype)
        stats = fallback_rate(frame, o.reshape(-1, 3), d.reshape(-1, 3), prec)
        rates[name] = float(stats["rate"])
        assert 0.0 <= rates[name] <= 1.0
    assert rates["bf16"] >= rates["fp32"]
    assert rates["bf16"] > 0.0  # the band is actually exercised


def test_fallback_rate_chunking_is_exact():
    """Ray chunking must not change the counts (same tests, same bands)."""
    host = cornell_box_scene()
    prec = get_precision("bf16")
    flat = build_flat_scene(host.root, host.active_camera)
    frame = frame_input_from_flat(flat, host, prec)
    o, d = primary_ray_grid(frame.cam_l2w, flat.cam_fov_y, 24, 24, prec.dtype)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    one = fallback_rate(frame, o, d, prec, chunk=o.shape[0])
    many = fallback_rate(frame, o, d, prec, chunk=100)  # uneven tail chunk
    assert one["tested"] == many["tested"]
    assert one["ambiguous"] == many["ambiguous"]


def test_pick_pixel_skips_non_pixel_arrays():
    """pick_pixel must only index (H, W, ...) pixel grids — a (4, 4)
    transform in the aux dict must not be reported as pixel data."""
    from low_precision_raytracer.utils.debug import pick_pixel

    H, W = 6, 8
    aux = {
        "albedo": jnp.arange(H * W * 3, dtype=jnp.float32).reshape(H, W, 3),
        "depth": jnp.arange(H * W, dtype=jnp.float32).reshape(H, W),
        "w2c": jnp.eye(4),
        "n_rays": jnp.asarray(7),
    }
    rec = pick_pixel(aux, x=2, y=1, height=H, width=W)
    assert set(rec) == {"albedo", "depth"}
    np.testing.assert_allclose(rec["depth"], 1 * W + 2)


# ---- Radiance RGBE (.hdr) decoder --------------------------------------


def _rgbe_encode(px):
    """Reference RGBE encode (Ward): e = exponent of max component,
    mantissa = c * 256 / 2^e."""
    m = float(max(px))
    if m < 1e-32:
        return bytes([0, 0, 0, 0])
    e = math.frexp(m)[1]
    s = 256.0 / 2.0**e
    return bytes([int(px[0] * s), int(px[1] * s), int(px[2] * s), e + 128])


def _write_hdr_flat(path, rgb):
    h, w = rgb.shape[:2]
    out = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    for row in rgb:
        for px in row:
            out += _rgbe_encode(px)
    path.write_bytes(out)


def _write_hdr_rle(path, rgb):
    """Adaptive-RLE scanlines: one run + literals per plane segment."""
    h, w = rgb.shape[:2]
    out = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    for row in rgb:
        raw = np.frombuffer(
            b"".join(_rgbe_encode(px) for px in row), np.uint8
        ).reshape(w, 4)
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            plane = raw[:, c]
            x = 0
            while x < w:
                # runs of equal bytes (>= 2) as run packets, else literals
                n = 1
                while x + n < w and plane[x + n] == plane[x] and n < 127:
                    n += 1
                if n >= 2:
                    out += bytes([128 + n, plane[x]])
                else:
                    out += bytes([1, plane[x]])
                x += n
    path.write_bytes(out)


def test_radiance_hdr_flat_roundtrip(tmp_path):
    from low_precision_raytracer.utils.image import load_radiance_hdr

    rng = np.random.default_rng(11)
    rgb = (rng.random((4, 9, 3)) * 100.0).astype(np.float32)
    rgb[0, 0] = [0.0, 0.0, 0.0]
    rgb[1, 2] = [1000.0, 0.25, 2.0]  # HDR range must survive
    p = tmp_path / "flat.hdr"
    _write_hdr_flat(p, rgb)
    dec = load_radiance_hdr(str(p))
    assert dec.shape == (4, 9, 3) and dec.dtype == np.float32
    # RGBE quantization: one mantissa LSB of the shared exponent scale
    # 2^(e-8) with 2^e >= max(px), i.e. up to max(px)/128 per component
    lsb = rgb.max(axis=-1, keepdims=True) / 128.0
    assert np.all(np.abs(dec - rgb) <= lsb * 1.01 + 1e-6)
    assert dec[1, 2, 0] > 255.0  # the LDR-clamp failure mode


def test_radiance_hdr_rle_roundtrip(tmp_path):
    from low_precision_raytracer.utils.image import load_radiance_hdr

    rng = np.random.default_rng(12)
    w = 33  # >= 8 so the RLE format is legal
    rgb = (rng.random((3, w, 3)) * 4.0).astype(np.float32)
    rgb[1, 5:20] = [2.0, 1.0, 0.5]  # constant stretch -> run packets
    p = tmp_path / "rle.hdr"
    _write_hdr_rle(p, rgb)
    dec = load_radiance_hdr(str(p))
    lsb = rgb.max(axis=-1, keepdims=True) / 128.0
    assert np.all(np.abs(dec - rgb) <= lsb * 1.01 + 1e-6)


def test_radiance_hdr_old_rle_repeat(tmp_path):
    from low_precision_raytracer.utils.image import load_radiance_hdr

    # old-style run: pixel [1,1,1,n] repeats the previous pixel n times
    w = 6  # < 8 -> forced flat/old format
    row0 = _rgbe_encode([3.0, 2.0, 1.0])
    out = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y 1 +X {w}\n".encode()
    out += row0 + bytes([1, 1, 1, w - 1])
    p = tmp_path / "old.hdr"
    p.write_bytes(out)
    dec = load_radiance_hdr(str(p))
    assert dec.shape == (1, w, 3)
    np.testing.assert_allclose(dec, np.tile([[3.0, 2.0, 1.0]], (1, w, 1)), rtol=0.01)


def test_radiance_hdr_old_rle_row_boundary(tmp_path):
    """An old-style run at x == 0 repeats the previous ROW's last pixel
    (Radiance's oldreadcolrs copies scan[-1] of the contiguous buffer); a
    run before any decoded pixel, and a run overrunning its row, raise."""
    from low_precision_raytracer.utils.image import load_radiance_hdr

    w = 5  # < 8 -> forced flat/old format
    hdr = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
    row0 = b"".join(_rgbe_encode([float(i + 1), 0.5, 0.25]) for i in range(w))
    # row 1 starts with a run of 3 (repeat row 0's LAST pixel), then 2 literals
    row1 = bytes([1, 1, 1, 3]) + _rgbe_encode([9.0, 1.0, 1.0]) * 2
    p = tmp_path / "rowrun.hdr"
    p.write_bytes(hdr + f"-Y 2 +X {w}\n".encode() + row0 + row1)
    dec = load_radiance_hdr(str(p))
    np.testing.assert_allclose(dec[1, :3], np.tile([[5.0, 0.5, 0.25]], (3, 1)), rtol=0.02)
    np.testing.assert_allclose(dec[1, 3:], np.tile([[9.0, 1.0, 1.0]], (2, 1)), rtol=0.02)

    import pytest

    # run before any pixel exists: corrupt
    p2 = tmp_path / "leadrun.hdr"
    p2.write_bytes(hdr + f"-Y 1 +X {w}\n".encode() + bytes([1, 1, 1, 2]) + row0[4:])
    with pytest.raises(ValueError):
        load_radiance_hdr(str(p2))
    # run overruns the row: corrupt
    p3 = tmp_path / "overrun.hdr"
    p3.write_bytes(
        hdr + f"-Y 1 +X {w}\n".encode() + row0[:4] + bytes([1, 1, 1, 200])
    )
    with pytest.raises(ValueError):
        load_radiance_hdr(str(p3))


def test_load_hdr_equirect_dispatch(tmp_path):
    from low_precision_raytracer.utils.image import load_hdr_equirect

    rgb = np.full((2, 8, 3), 2.5, np.float32)
    p = tmp_path / "sky.hdr"
    _write_hdr_flat(p, rgb)
    dec = load_hdr_equirect(str(p))
    np.testing.assert_allclose(dec, rgb, rtol=0.01)


def test_radiance_hdr_corrupt_files_raise_valueerror(tmp_path):
    import pytest
    """Corrupt/truncated .hdr files must raise ValueError naming the file,
    never leak decoder internals (IndexError/broadcast errors)."""
    from low_precision_raytracer.utils.image import load_radiance_hdr

    hdr = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
    cases = [
        b"",
        hdr,  # no resolution line
        hdr + b"-Y 4 +X 4\n" + b"\x01\x02",  # truncated pixel data
        hdr + b"-Y 99999 +X 99999\n" + b"\x00" * 64,  # implausible dims
        hdr + b"-Y 2 +X 8\n" + b"\x02\x02\x00\x08" + b"\xff\x09" * 2,  # bad run
    ]
    for i, data in enumerate(cases):
        p = tmp_path / f"bad{i}.hdr"
        p.write_bytes(data)
        with pytest.raises(ValueError) as ei:
            load_radiance_hdr(str(p))
        assert str(p) in str(ei.value)
