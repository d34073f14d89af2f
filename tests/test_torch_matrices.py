"""The PyTorch port's host math against the JAX package's.

``voltools_tpu_torch.utils`` keeps its own copy of the matrix builders and
device helpers (importing ``voltools_tpu.utils`` would import JAX); these
tests hold the copy to the original on all 24 Euler orders, the composed
transform, the Rodrigues matrix and the reshape geometry, at atol 1e-6."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import voltools_tpu.utils as jut
import voltools_tpu_torch.utils as tut

ANGLE_SETS = [(17.0, -33.0, 71.0), (-180.0, 90.0, 45.5), (0.0, 0.0, 0.0),
              (359.0, -721.0, 12.25)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_registry_matches():
    assert tut.AVAILABLE_ROTATIONS == jut.AVAILABLE_ROTATIONS
    assert len(tut.AVAILABLE_ROTATIONS) == 24
    assert tut.AVAILABLE_UNITS == jut.AVAILABLE_UNITS


@pytest.mark.parametrize("order", jut.AVAILABLE_ROTATIONS)
def test_rotation_matrix_matches_jax(order):
    for angles in ANGLE_SETS:
        np.testing.assert_allclose(tut.rotation_matrix(angles, "deg", order),
                                   jut.rotation_matrix(angles, "deg", order),
                                   atol=1e-6)
        rad = np.deg2rad(angles)
        np.testing.assert_allclose(tut.rotation_matrix(rad, "rad", order),
                                   jut.rotation_matrix(rad, "rad", order),
                                   atol=1e-6)


def test_rotation_matrix_rejects_bad_arguments():
    with pytest.raises(ValueError):
        tut.rotation_matrix((1, 2, 3), "grad", "sxyz")
    with pytest.raises(ValueError):
        tut.rotation_matrix((1, 2, 3), "deg", "xyzw")


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(translation=(1.5, -2.0, 3.25)),
    dict(rotation=(30, -20, 10), rotation_order="sxyz",
         center=(12.0, 13.5, 14.0)),
    dict(scale=(1.2, 0.8, 1.1), shear=(0.1, -0.2, 0.05),
         rotation=(5, 40, -70), rotation_order="rzxz",
         translation=(0.5, 0.25, -1.0), center=(8, 9, 10)),
    dict(rotation=(1.0, 0.5, -0.25), rotation_units="rad",
         rotation_order="ryzy", center=(3, 3, 3)),
    dict(scale=(2.0, 2.0, 2.0), center=(0.5, 0.5, 0.5)),
], ids=["identity", "translate", "rotate_center", "full", "radians",
        "scale_center"])
def test_transform_matrix_matches_jax(kwargs):
    np.testing.assert_allclose(tut.transform_matrix(**kwargs),
                               jut.transform_matrix(**kwargs), atol=1e-6)


def test_elementary_matrices_match_jax():
    t = (1.0, -2.5, 3.0)
    np.testing.assert_array_equal(tut.translation_matrix(t),
                                  jut.translation_matrix(t))
    np.testing.assert_array_equal(tut.scale_matrix(t), jut.scale_matrix(t))
    np.testing.assert_array_equal(tut.shear_matrix(t), jut.shear_matrix(t))
    assert tut.translation_matrix(t).dtype == np.float32


@pytest.mark.parametrize("center", [None, (10.0, 11.5, 12.0)])
def test_rodrigues_matches_jax(center):
    rng = np.random.default_rng(3)
    for _ in range(4):
        w = rng.normal(size=3).astype(np.float32)
        got = tut.rodrigues_matrix(torch.from_numpy(w), center=center)
        want = np.asarray(jut.rodrigues_matrix(w, center=center))
        assert got.dtype == torch.float32 and got.shape == (4, 4)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_rodrigues_is_differentiable_and_matches_transform_matrix():
    w = torch.tensor([0.0, 0.0, 0.3], requires_grad=True)
    center = (5.0, 6.0, 7.0)
    m = tut.rodrigues_matrix(w, center=center)
    expected = tut.transform_matrix(rotation=(0, 0, -np.degrees(0.3)),
                                    rotation_order="sxyz", center=center)
    np.testing.assert_allclose(m.detach().numpy(), expected, atol=1e-6)
    m[:3, :3].sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()


@pytest.mark.parametrize("shape,kwargs", [
    ((17, 19, 23), dict(rotation=(30, 0, 0), rotation_order="rzxz",
                        center=(8, 9, 11))),
    ((8, 40, 5), dict(scale=(0.5, 1.5, 2.0), shear=(0.2, 0, 0.1))),
    ((10, 10, 10), dict(translation=(3.0, -4.0, 0.5))),
])
def test_post_transform_dimensions_match_jax(shape, kwargs):
    m = jut.transform_matrix(**kwargs)
    for got, want in zip(tut.compute_post_transform_dimensions(shape, m),
                         jut.compute_post_transform_dimensions(shape, m)):
        np.testing.assert_array_equal(got, want)


def test_post_transform_dimensions_singular_raises():
    with pytest.raises(np.linalg.LinAlgError):
        tut.compute_post_transform_dimensions((4, 4, 4), np.zeros((4, 4)))


def test_available_devices():
    devices = tut.get_available_devices()
    assert devices[0] == "cpu"
    if not torch.cuda.is_available():
        assert devices == ["cpu"]
    else:
        assert "cuda" in devices and "cuda:0" in devices


@pytest.mark.parametrize("device", ["cuda:", "cuda:x", "cuda:-1", "cuda:0x",
                                    "gpu", "tpu", "jax", "cuda:99999"])
def test_resolve_device_rejects_malformed_or_absent(device):
    with pytest.raises(ValueError):
        tut.resolve_device(device)


def test_resolve_device_cpu_and_missing_cuda():
    assert tut.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert tut.resolve_device("cuda") == torch.device("cuda", 0)
    else:
        with pytest.raises(ValueError, match="No CUDA device"):
            tut.resolve_device("cuda")


def test_profile_timer_prints(capsys):
    with tut.ProfileTimer():
        pass
    assert "transform finished in" in capsys.readouterr().out
