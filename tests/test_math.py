import numpy as np

from low_precision_raytracer.math.hostmath import (
    cross_product_difference,
    difference_of_products,
    inverse_3x3_dop,
    look_at,
    perspective,
    quaternion_to_matrix,
    trs_matrix,
)


def test_difference_of_products_exactness():
    rng = np.random.default_rng(0)
    a, b, c, d = rng.normal(size=(4, 1000)).astype(np.float32)
    got = difference_of_products(a, b, c, d)
    want = (a.astype(np.float64) * b - c.astype(np.float64) * d).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cross_product_difference_matches_cross():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(100, 3)).astype(np.float32)
    b = rng.normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_allclose(
        cross_product_difference(a, b), np.cross(a, b), rtol=1e-4, atol=1e-6
    )


def test_inverse_3x3_vs_numpy():
    rng = np.random.default_rng(2)
    m = rng.normal(size=(50, 3, 3)).astype(np.float32)
    m += np.eye(3, dtype=np.float32) * 0.5
    inv = inverse_3x3_dop(m)
    want = np.linalg.inv(m.astype(np.float64))
    np.testing.assert_allclose(inv, want, rtol=2e-3, atol=1e-4)


def test_quaternion_identity_and_rotation():
    np.testing.assert_allclose(
        quaternion_to_matrix(np.array([0, 0, 0, 1], np.float32)), np.eye(4), atol=1e-7
    )
    # 90 deg about z: x -> y
    q = np.array([0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)], np.float32)
    m = quaternion_to_matrix(q)
    np.testing.assert_allclose(m[:3, :3] @ [1, 0, 0], [0, 1, 0], atol=1e-6)


def test_trs_order():
    # scale then rotate then translate
    q = np.array([0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)], np.float32)
    m = trs_matrix([1, 2, 3], q, [2, 1, 1])
    p = m @ np.array([1, 0, 0, 1], np.float32)
    np.testing.assert_allclose(p[:3], [1, 4, 3], atol=1e-5)


def test_look_at_inverse_consistency():
    w2v = look_at([0, 0, 3], [0, 0, 0], [0, 1, 0])
    # eye maps to origin, forward maps to -z
    np.testing.assert_allclose(w2v @ [0, 0, 3, 1], [0, 0, 0, 1], atol=1e-6)
    np.testing.assert_allclose((w2v @ [0, 0, 0, 1])[:3], [0, 0, -3], atol=1e-6)


def test_perspective_depth_range():
    m = perspective(np.pi / 2, 100, 100, 0.1, 100.0)
    near = m @ [0, 0, -0.1, 1]
    far = m @ [0, 0, -100.0, 1]
    np.testing.assert_allclose(near[2] / near[3], -1, atol=1e-5)
    np.testing.assert_allclose(far[2] / far[3], 1, atol=1e-5)
