"""The CUDA affine kernel on the card: skipped on a host without one.

These tests import torch and the port only, so they run where JAX is not
installed.  ``tests/conftest.py`` imports JAX, so on such a machine run::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

The first test to launch the kernel builds it with nvcc."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import voltools_tpu_torch as vt
from voltools_tpu_torch.kernels.affine_resample import affine_resample
from voltools_tpu_torch.ops.sampling import affine_sample
from voltools_tpu_torch.utils import transform_matrix

pytestmark = pytest.mark.cuda

ATOL = 5e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def matrices(shape, seed):
    rng = np.random.default_rng(seed)
    center = tuple(s / 2 for s in shape)
    ms = [transform_matrix(rotation=tuple(rng.uniform(-180, 180, 3)),
                           rotation_order="sxyz", center=center)
          for _ in range(2)]
    ms.append(transform_matrix(shear=(0.11, -0.07, 0.19), center=center))
    return torch.from_numpy(np.stack(ms).astype(np.float32))


@pytest.mark.parametrize("shape", [(23, 29, 31), (1, 9, 10), (6, 1, 140)])
@pytest.mark.parametrize("mode", ["constant", "border"])
@pytest.mark.parametrize("order", [1, 3])
def test_kernel_matches_plain_version(dev, shape, mode, order):
    """Coordinates are rounded alike on both sides, so every voxel agrees,
    knife edges included."""
    vol = torch.from_numpy(np.random.default_rng(0).random(shape).astype(
        np.float32)).to(dev)
    ms = matrices(shape, seed=shape[0]).to(dev)
    interp = "linear" if order == 1 else "bspline"
    for cval in (0.0, 1.5):
        got = affine_resample(vol, ms, order, mode, cval)
        for i in range(len(ms)):
            want = affine_sample(vol, ms[i], interp, mode, cval,
                                 prefiltered=True)
            torch.testing.assert_close(got[i], want, atol=ATOL, rtol=0)


def test_launch_counter_and_out_buffer(dev):
    vol = torch.rand((12, 13, 14), device=dev)
    ms = matrices((12, 13, 14), seed=1).to(dev)
    before = affine_resample.launches
    out = torch.empty((12, 13, 14), device=dev)
    assert affine_resample(vol, ms[0], 3, out=out) is out
    stack = affine_resample(vol, ms, 3)
    assert affine_resample.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(out, stack[0])


def test_side_stream_and_out_shape(dev):
    vol = torch.rand((10, 11, 12), device=dev)
    m = matrices((10, 11, 12), seed=2)[0].to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = affine_resample(vol, m, 1, out_shape=(4, 20, 33))
    torch.cuda.current_stream().wait_stream(side)
    want = affine_sample(vol, m, "linear", prefiltered=True,
                         out_shape=(4, 20, 33))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_launch_leaves_current_device(dev):
    """A launch on the last card runs there and leaves the caller's current
    device as it was (with one card, both are card 0)."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    vol = torch.rand((9, 10, 11), device=last)
    m = matrices((9, 10, 11), seed=5)[0].to(last)
    torch.cuda.set_device(0)
    got = affine_resample(vol, m, 3)
    assert torch.cuda.current_device() == 0
    assert got.device == last
    want = affine_sample(vol, m, "bspline", prefiltered=True)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_mixed_devices_raise(dev):
    vol = torch.rand((4, 4, 4), device=dev)
    with pytest.raises(ValueError):
        affine_resample(vol, torch.eye(4), 1)


@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
def test_api_on_cuda_matches_cpu(dev, interpolation):
    vol = np.random.default_rng(3).random((20, 21, 22)).astype(np.float32)
    ms = matrices(vol.shape, seed=4).numpy()
    gpu = vt.StaticVolume(vol, interpolation, device="cuda", cval=0.5)
    cpu = vt.StaticVolume(vol, interpolation, device="cpu", cval=0.5)
    np.testing.assert_allclose(gpu.data.cpu().numpy(), cpu.data.numpy(),
                               atol=1e-5)
    res = gpu.affine(ms[0], output="device")
    assert res.is_cuda and vt.last_dispatch()["impl"] == "cuda"
    np.testing.assert_allclose(res.cpu().numpy(), cpu.affine(ms[0]),
                               atol=ATOL)
    np.testing.assert_allclose(gpu.affine_batch(ms), cpu.affine_batch(ms),
                               atol=ATOL)
    np.testing.assert_allclose(
        vt.affine(vol, ms[1], interpolation, reshape=True, device="cuda"),
        vt.affine(vol, ms[1], interpolation, reshape=True, device="cpu"),
        atol=ATOL)
