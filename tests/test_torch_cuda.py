"""The CUDA affine kernels on the card: skipped on a host without one.

These tests import torch and the port only, so they run where JAX is not
installed.  ``tests/conftest.py`` imports JAX, so on such a machine run::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

The first test to launch a kernel builds it with nvcc."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import voltools_tpu_torch as vt
from voltools_tpu_torch.kernels import _build
from voltools_tpu_torch.kernels.affine_resample import (DEEP_PATCH,
                                                        FLAT_PATCH,
                                                        affine_resample,
                                                        fast_path_voxels,
                                                        reset_fast_path_voxels)
from voltools_tpu_torch.kernels.affine_slab import (affine_slab,
                                                    blocks_per_sm, overflows)
from voltools_tpu_torch.kernels.backproject import (backproject,
                                                    plain_backproject,
                                                    row_gather)
from voltools_tpu_torch.kernels.layout import pitched, tma_ready
from voltools_tpu_torch.kernels.partial_sample import (
    RING_CAPACITY, LIBRARY as partial_library, line_axis, partial_project,
    partial_sample, partial_sample_ring, plain_partial_project,
    plain_partial_ring, sum_order_atol)
from voltools_tpu_torch.kernels.planner import (BRICK, SMEM_BUDGET, SlabPlan,
                                                slab_extents, slab_plan)
from voltools_tpu_torch.models import (TiltSeriesProjector,
                                       phase_cross_correlation, register,
                                       sirt_reconstruct, wbp_reconstruct)
from voltools_tpu_torch.ops.sampling import affine_sample
from voltools_tpu_torch.utils import (rodrigues_matrix, transform_matrix,
                                      translation_matrix)

pytestmark = pytest.mark.cuda

ATOL = 5e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launched(*names):
    """The launches of this process under each of ``names``."""
    counts = _build.launches()
    return tuple(counts[name] for name in names)


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
    before = _build.launches()["affine_resample"]
    out = torch.empty((12, 13, 14), device=dev)
    assert affine_resample(vol, ms[0], 3, out=out) is out
    stack = affine_resample(vol, ms, 3)
    assert _build.launches()["affine_resample"] == before + 2
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


@pytest.mark.parametrize("shape", [(23, 29, 31), (1, 9, 10), (6, 1, 140)])
@pytest.mark.parametrize("mode", ["constant", "border"])
@pytest.mark.parametrize("order", [1, 3])
def test_slab_kernel_equals_walk_kernel(dev, shape, mode, order):
    """The two kernels share their per-voxel arithmetic: bit-identical
    results, and the plain version's to within ATOL.  A matrix whose box
    is over the slab kernel's budget (boxes are not capped at a small
    volume) is the walk kernel's alone."""
    vol = pitched(torch.from_numpy(np.random.default_rng(1).random(
        shape).astype(np.float32)).to(dev))
    ms = matrices(shape, seed=shape[0])
    ms_dev = ms.to(dev)
    interp = "linear" if order == 1 else "bspline"
    before = overflows(dev)
    compared = 0
    for cval in (0.0, 1.5):
        for i in range(len(ms)):
            plan = slab_plan(ms[i].numpy(), shape, interp, mode)
            if plan is None:
                assert 4 * np.prod(slab_extents(ms[i].numpy(), shape,
                                                order)) > SMEM_BUDGET
                continue
            compared += 1
            assert blocks_per_sm(plan, dev) >= 1
            got = affine_slab(vol, ms_dev[i], order, mode, cval, plan=plan)
            assert torch.equal(got, affine_resample(vol, ms_dev[i], order,
                                                    mode, cval))
            want = affine_sample(vol, ms_dev[i], interp, mode, cval,
                                 prefiltered=True)
            torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert compared >= 4
    assert overflows(dev) == before


def test_slab_batch_counter_and_out_buffer(dev):
    shape = (12, 13, 14)
    vol = pitched(torch.rand(shape, device=dev))
    ms = matrices(shape, seed=1)
    plan = slab_plan(ms.numpy(), shape, "bspline")
    ms = ms.to(dev)
    before = _build.launches()["affine_slab"]
    out = torch.empty(shape, device=dev)
    assert affine_slab(vol, ms[0], 3, out=out) is out    # plans here
    stack = affine_slab(vol, ms, 3, plan=plan)
    assert _build.launches()["affine_slab"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(out, stack[0])
    assert torch.equal(stack, affine_resample(vol, ms, 3))


def test_slab_overflow_is_counted_and_still_right(dev):
    """A plan whose box is too small for the matrix: the kernel reads the
    taps outside each box from global memory, and counts."""
    shape = (20, 21, 22)
    vol = pitched(torch.rand(shape, device=dev))
    m = matrices(shape, seed=2)[0].to(dev)
    small = SlabPlan(1, "constant", shape, shape, (2, 2, 4))
    before = overflows(dev)
    got = affine_slab(vol, m, 1, plan=small)
    assert overflows(dev) > before
    assert torch.equal(got, affine_resample(vol, m, 1))


def test_slab_launch_leaves_current_device(dev):
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    vol = pitched(torch.rand((9, 10, 11), device=last))
    m = matrices((9, 10, 11), seed=5)[0].to(last)
    torch.cuda.set_device(0)
    got = affine_slab(vol, m, 3)
    assert torch.cuda.current_device() == 0
    assert got.device == last
    assert torch.equal(got, affine_resample(vol, m, 3))


@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
def test_projector_and_reconstruction_on_cuda_match_cpu(dev, interpolation):
    vol = np.random.default_rng(6).random((20, 22, 24)).astype(np.float32)
    angles = np.arange(-60.0, 61.0, 20.0)
    gpu = TiltSeriesProjector(vol, interpolation, device="cuda")
    cpu = TiltSeriesProjector(vol, interpolation, device="cpu")
    assert tma_ready(gpu.data)
    before = sum(_launched("affine_slab", "affine_resample"))
    p_gpu = gpu.project(angles, tilt_axis=0, output="device")
    assert p_gpu.is_cuda
    assert sum(_launched("affine_slab", "affine_resample")) == before + 1
    p_cpu = cpu.project(angles, tilt_axis=0)
    # each projection sums 20 voxels that agree to ATOL
    np.testing.assert_allclose(p_gpu.cpu().numpy(), p_cpu, atol=20 * ATOL)
    ms = cpu.tilt_matrices(angles, tilt_axis=0)
    np.testing.assert_allclose(
        wbp_reconstruct(p_gpu, ms, vol.shape, device="cuda"),
        wbp_reconstruct(p_cpu, ms, vol.shape, device="cpu"), atol=1e-4)
    np.testing.assert_allclose(
        sirt_reconstruct(p_gpu, ms, vol.shape, iterations=3, nonneg=True,
                         device="cuda"),
        sirt_reconstruct(p_cpu, ms, vol.shape, iterations=3, nonneg=True,
                         device="cpu"), atol=1e-4)


def _slab_equals_walk(vol, ms, order, mode="constant", cval=0.0, plan=None):
    """B on ``vol`` (pitched here) equals A bit for bit, with no overflow;
    returns B's result."""
    interp = "linear" if order == 1 else "bspline"
    shape = tuple(vol.shape)
    plan = plan or slab_plan(ms.cpu().numpy(), shape, interp, mode)
    assert plan is not None
    before = overflows(vol.device)
    got = affine_slab(pitched(vol), ms, order, mode, cval, plan=plan)
    assert torch.equal(got, affine_resample(vol, ms, order, mode, cval))
    assert overflows(vol.device) == before
    return got


@pytest.mark.parametrize("order", [1, 3])
def test_slab_walks_more_items_than_its_grid(dev, order):
    """64 matrices on (40, 48, 56): 3840 (trilinear) or 7680 (cubic)
    items, several passes of the persistent grid over them."""
    shape = (40, 48, 56)
    center = tuple((s - 1) / 2 for s in shape)
    ms = torch.from_numpy(np.stack([
        transform_matrix(rotation=(0.0, float(a), 0.0), rotation_order="rzxz",
                         center=center)
        for a in np.linspace(-60, 60, 64)]).astype(np.float32)).to(dev)
    vol = torch.rand(shape, device=dev)
    plan = slab_plan(ms.cpu().numpy(), shape,
                     "linear" if order == 1 else "bspline")
    bricks = int(np.prod([-(-n // b) for n, b in zip(shape, BRICK[order])]))
    assert 64 * bricks > torch.cuda.get_device_properties(
        dev).multi_processor_count * blocks_per_sm(plan, dev)
    _slab_equals_walk(vol, ms, order, plan=plan)


def test_slab_takes_more_matrices_than_a_grid_dimension(dev):
    """70000 matrices in one launch, past the 65535 of a grid's y; the walk
    kernel takes them in two launches."""
    shape = (4, 8, 32)
    rng = np.random.default_rng(8)
    ms = torch.from_numpy(np.stack([
        translation_matrix(tuple(rng.uniform(-2.0, 2.0, 3)))
        for _ in range(70000)]).astype(np.float32)).to(dev)
    vol = pitched(torch.rand(shape, device=dev))
    plan = slab_plan(ms.cpu().numpy(), shape, "linear")
    before = overflows(dev)
    got = affine_slab(vol, ms, 1, plan=plan)
    want = torch.cat([affine_resample(vol, ms[:65535], 1),
                      affine_resample(vol, ms[65535:], 1)])
    assert torch.equal(got, want)
    assert overflows(dev) == before


@pytest.mark.parametrize("shape", [(6, 10, 250), (9, 7, 56), (20, 30, 1)])
@pytest.mark.parametrize("order", [1, 3])
def test_slab_reads_pitched_and_unpitched_widths(dev, shape, order):
    """One pitched buffer serves both kernels at widths of 4k + 2, 4k and
    1; the walk kernel gives the same on the pitched and the contiguous
    volume, and the slab kernel refuses a contiguous width it cannot read
    with TMA."""
    vol = torch.from_numpy(np.random.default_rng(2).random(shape).astype(
        np.float32)).to(dev)
    center = tuple((s - 1) / 2 for s in shape)
    ms = torch.from_numpy(np.stack([
        transform_matrix(rotation=(0.0, 35.0, 0.0), rotation_order="rzxz",
                         center=center),
        transform_matrix(shear=(0.11, -0.07, 0.19), center=center),
        translation_matrix((0.3, -1.7, 2.2))]).astype(np.float32)).to(dev)
    p = pitched(vol)
    assert tma_ready(p) and torch.equal(p, vol)
    assert (p.stride(1) == shape[2]) == (shape[2] % 4 == 0)
    for mode in ("constant", "border"):
        for i in range(len(ms)):
            got = _slab_equals_walk(vol, ms[i], order, mode, 1.5)
            assert torch.equal(affine_resample(p, ms[i], order, mode, 1.5),
                               got)
    if shape[2] % 4:
        with pytest.raises(ValueError, match="TMA"):
            affine_slab(vol, ms[0], order)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("mode", ["constant", "border"])
def test_slab_boxes_past_both_ends_of_the_volume(dev, order, mode):
    """A source 2.5 voxels below the output, and a scale of 1.2 about the
    centre: the first bricks' boxes start below 0 and the last ones end
    past the volume; TMA fills the outside with zeros, which no tap
    reads."""
    shape = (13, 21, 38)
    center = tuple((s - 1) / 2 for s in shape)
    ms = np.stack([translation_matrix((2.5, 2.5, 2.5)),
                   transform_matrix(scale=(1.2, 1.2, 1.2), center=center)])
    interp = "linear" if order == 1 else "bspline"
    first_tap = 0 if order == 1 else -1
    n = np.array(shape)
    brick = np.array(BRICK[order])
    last = (n - 1) // brick * brick
    for m in ms:
        extents = np.array(slab_plan(m, shape, interp, mode).extents)
        # the boxes as the kernel places them: from floor(min corner) +
        # first tap - 1, the plan's extents long
        for lo, hi in ((np.zeros(3), np.minimum(brick, n) - 1),
                       (last, n - 1)):
            corners = np.array([[z, y, x, 1.0] for z in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for x in (lo[2], hi[2])]).T
            start = np.floor((m.astype(np.float32) @ corners)[:3].min(
                axis=1)) + first_tap - 1
            if lo.any():
                assert (start + extents - 1 > n - 1).all()
            else:
                assert (start < 0).all()
    vol = torch.rand(shape, device=dev)
    ms = torch.from_numpy(ms.astype(np.float32)).to(dev)
    for i in range(len(ms)):
        _slab_equals_walk(vol, ms[i], order, mode, 0.5)
    _slab_equals_walk(vol, ms, order, mode, 0.5)


def near_edge_matrices(shape):
    """Matrices whose source points reach the edges and knife edges (the
    identity, whole- and half-voxel translations, a scale just off 1,
    rotations by 90 and 3 degrees about the centre), a tilt and a rotation
    mixing all three axes."""
    center = tuple((s - 1) / 2 for s in shape)
    return np.stack([
        np.eye(4), translation_matrix((1.0, 0.0, -1.0)),
        translation_matrix((0.5, -0.5, 0.25)),
        transform_matrix(scale=(1.02, 0.98, 1.01), center=center),
        transform_matrix(rotation=(90, 0, 0), rotation_order="rzxz",
                         center=center),
        transform_matrix(rotation=(3, 2, 1), rotation_order="sxyz",
                         center=center),
        transform_matrix(rotation=(0, 30, 0), rotation_order="rzxz",
                         center=center),
        transform_matrix(rotation=(40, 50, 60), rotation_order="sxyz",
                         center=center)]).astype(np.float32)


@pytest.mark.parametrize("shape,out_shape", [
    ((23, 29, 31), None), ((17, 21, 32), None), ((1, 9, 10), None),
    ((6, 1, 141), None), ((40, 48, 56), None), ((23, 29, 31), (9, 33, 17))])
@pytest.mark.parametrize("patch", [FLAT_PATCH, DEEP_PATCH])
@pytest.mark.parametrize("order", [1, 3])
def test_walk_paths_equal_the_plain_version_and_the_slab_kernel(
        dev, shape, out_shape, patch, order):
    """Near-edge and knife-edge matrices, both warp patches, ragged shapes,
    contiguous widths of 4k + 3, 4k + 1 and 4k, and the pitched volume
    (float4 cubic rows): the walk kernel's fast and edge paths equal the
    plain version, and the slab kernel where its box fits, bit for bit."""
    vol = torch.from_numpy(np.random.default_rng(sum(shape)).random(
        shape).astype(np.float32)).to(dev)
    pvol = pitched(vol, copy=True)
    ms = near_edge_matrices(shape)
    ms_dev = torch.from_numpy(ms).to(dev)
    interp = "linear" if order == 1 else "bspline"
    out = tuple(shape if out_shape is None else out_shape)
    for mode in ("constant", "border"):
        for cval in (0.0, 1.5):
            got = affine_resample(vol, ms_dev, order, mode, cval, out,
                                  patch=patch)
            assert torch.equal(got, affine_resample(
                pvol, ms_dev, order, mode, cval, out, patch=patch))
            for i in range(len(ms)):
                want = affine_sample(vol, ms_dev[i], interp, mode, cval,
                                     prefiltered=True, out_shape=out)
                assert torch.equal(got[i], want), (mode, cval, i)
                plan = slab_plan(ms[i], shape, interp, mode, out)
                if plan is not None:
                    assert torch.equal(affine_slab(
                        pvol, ms_dev[i], order, mode, cval, out,
                        plan=plan), got[i]), (mode, cval, i, "slab")


@pytest.mark.parametrize("patch", [FLAT_PATCH, DEEP_PATCH])
def test_walk_takes_both_paths_on_near_edge_and_random_sets(dev, patch):
    """The cases above reach both of the walk kernel's cubic paths, as the
    kernel counts them on the device: the near-edge set has warps on the
    edge path, random rotations have warps on the fast path.  Per launch
    the count of in-range voxels on the fast path equals that of the
    kernel's thread mapping and warp vote emulated on the host (trilinear:
    none), on the contiguous and the pitched volume."""
    from test_torch_walk_design import warp_path_counts

    shape = (40, 48, 56)
    vol = torch.rand(shape, device=dev)
    pvol = pitched(vol, copy=True)
    sets = {"near": near_edge_matrices(shape),
            "random": matrices(shape, seed=7).numpy()}
    fast_share = {}
    for name, ms in sets.items():
        for order in (1, 3):
            for mode in ("constant", "border"):
                fast = edge = 0
                for m in ms:
                    want = warp_path_counts(shape, m, order, shape, patch,
                                            mode)
                    for v in (vol, pvol):
                        reset_fast_path_voxels(dev)
                        affine_resample(v, torch.from_numpy(m).to(dev),
                                        order, mode, patch=patch)
                        assert fast_path_voxels(dev) == want[0], (
                            name, order, mode)
                    fast += want[0]
                    edge += want[1]
                if order == 3 and mode == "constant":
                    fast_share[name] = fast / (fast + edge)
    assert fast_share["near"] < 1.0
    assert fast_share["random"] > 0.5


def test_walk_takes_matrices_off_16_byte_boundaries(dev):
    """The kernel reads a matrix row as one 16-byte load: a matrix that
    starts 4 bytes past a boundary is copied first, with the same result."""
    vol = torch.rand((11, 12, 13), device=dev)
    flat = torch.zeros(40, device=dev)
    m = flat[1:17].view(4, 4)
    m.copy_(matrices((11, 12, 13), seed=3)[0].to(dev))
    assert m.data_ptr() % 16 == 4 and m.is_contiguous()
    for order in (1, 3):
        assert torch.equal(affine_resample(vol, m, order),
                           affine_resample(vol, m.clone(), order))


def _registration_pair(shape, seed):
    """A smooth volume and its copy through a hidden rigid transform."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    ref = gaussian_filter(rng.standard_normal(shape), 2.0)
    ref = (ref / np.abs(ref).max()).astype(np.float32)
    center = tuple((s - 1) / 2 for s in shape)
    m = rodrigues_matrix(torch.tensor([0.05, -0.07, 0.06]), center).numpy()
    m[:3, 3] -= np.asarray([1.4, -0.8, 0.6], np.float32)
    mov = affine_sample(torch.from_numpy(ref), m, "linear").numpy()
    return mov, ref


@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
def test_registration_on_cuda_matches_cpu(dev, interpolation):
    """The same registration on the card and on the CPU: theta within 1e-3
    rad and 1e-2 voxel, the first 5 losses within 1e-4 relative; the phase
    correlation lands on the same grid point."""
    mov, ref = _registration_pair((32, 32, 32), seed=12)
    shift = phase_cross_correlation(ref, mov, upsample=10, device="cuda")
    assert shift.is_cuda
    np.testing.assert_allclose(shift.cpu().numpy(), phase_cross_correlation(
        ref, mov, upsample=10, device="cpu").numpy(), atol=1e-6)
    kw = dict(model="rigid", loss="ncc", levels=2, steps=60,
              interpolation=interpolation)
    gpu = register(mov, ref, device="cuda", **kw)
    cpu = register(mov, ref, device="cpu", **kw)
    np.testing.assert_allclose(gpu.params["w"], cpu.params["w"], atol=1e-3)
    np.testing.assert_allclose(gpu.params["t"], cpu.params["t"], atol=1e-2)
    np.testing.assert_allclose(gpu.loss_history[:5], cpu.loss_history[:5],
                               rtol=1e-4)
    assert gpu.loss_history[-1] < gpu.loss_history[0]


def test_cpu_backend_with_a_cuda_device_raises(dev):
    vol = np.zeros((8, 8, 8), np.float32)
    for backend in ("scipy", "native"):
        with pytest.raises(ValueError, match="device='cpu' only"):
            vt.affine(vol, np.eye(4), device="cuda", cpu_backend=backend)


def test_registration_result_apply_launches_kernel_a(dev):
    mov, ref = _registration_pair((24, 24, 24), seed=13)
    res = register(mov, ref, model="rigid", steps=20, device="cuda")
    before = _launched("affine_resample", "affine_slab")
    out = res.apply(mov, device="cuda", output="device")
    assert _launched("affine_resample", "affine_slab") == (
        before[0] + 1, before[1])
    assert vt.last_dispatch()["impl"] == "cuda"
    want = affine_sample(torch.from_numpy(mov).to(dev),
                         torch.from_numpy(res.matrix).to(dev), "linear")
    assert torch.equal(out, want)


def _mesh4(dev):
    """Four shards on one card: every collective path of a 4-device
    mesh."""
    from voltools_tpu_torch.parallel import Mesh
    return Mesh([dev] * 4)


@pytest.mark.parametrize("shape", [(40, 24, 28), (38, 24, 28)])
@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
@pytest.mark.parametrize("mode", ["constant", "border"])
def test_sharded_volume_on_a_4_shard_mesh(dev, shape, interpolation, mode):
    """The halo, gather and stream bodies on a 4-shard mesh on one card,
    held against StaticVolume on the same card (atol 3e-5, 5e-4 off knife
    edges for the global bodies); 38 planes pad to 40.  The halo and
    gather bodies launch A or B once per shard; the stream body launches
    neither, and D1's ring entry once per shard (the four slabs share the
    card), its per-step entry never."""
    from voltools_tpu_torch.parallel import ShardedVolume
    vol = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    center = tuple(s / 2 for s in shape)
    local_m = transform_matrix(rotation=(3, -4, 5), rotation_order="sxyz",
                               center=center)
    global_m = transform_matrix(rotation=(111, -67, 148),
                                rotation_order="sxyz", center=center)
    single = vt.StaticVolume(vol, interpolation, device="cuda", mode=mode,
                             cval=1.5)
    for strategy in ("stream", "gather"):
        sv = ShardedVolume(vol, interpolation, mesh=_mesh4(dev), mode=mode,
                           cval=1.5, global_strategy=strategy)
        for m, atol in ((local_m, 3e-5), (global_m, 5e-4)):
            names = ("affine_resample", "affine_slab", "partial_sample",
                     "partial_sample_ring")
            before = _launched(*names)
            slabs = sv.affine(m, output="device")
            walk, slab, d1, ring = np.subtract(_launched(*names), before)
            global_stream = m is global_m and strategy == "stream"
            assert walk + slab == (0 if global_stream else 4)
            assert d1 == 0
            assert ring == (4 if global_stream else 0)
            assert all(s.device == dev for s in slabs)
            got = torch.cat(slabs)
            want = single.affine(m, output="device")
            off, _ = _errors_off_knife(got, want, m)
            assert off <= atol, (strategy, off)


def _errors_off_knife(got, want, m, tol=1e-4):
    diff = (got.double() - want.double()).abs()
    idx = [torch.arange(n, dtype=torch.float64, device=got.device)
           for n in got.shape]
    grid = torch.meshgrid(*idx, indexing="ij")
    mm = torch.as_tensor(np.asarray(m, np.float64), device=got.device)
    near = torch.zeros(got.shape, dtype=torch.bool, device=got.device)
    for a in range(3):
        s = mm[a, 0] * grid[0] + mm[a, 1] * grid[1] + mm[a, 2] * grid[2] \
            + mm[a, 3]
        near |= (s - s.round()).abs() < tol
        near |= (s - (s + 0.5).round() + 0.5).abs() < tol
    return float(torch.where(near, 0.0, diff).max()), float(diff.max())


def test_sharded_batch_and_reconstructions_on_a_4_shard_mesh(dev):
    """sharded_affine_batch and the mesh reconstructions on a 4-shard mesh
    on one card, against the single-device calls: the batch within 3e-5,
    WBP and SIRT within 1e-4 of the largest value."""
    from voltools_tpu_torch.parallel import sharded_affine_batch
    shape = (40, 36, 32)
    vol = np.random.default_rng(5).random(shape).astype(np.float32)
    proj = TiltSeriesProjector(vol, "linear", device="cuda")
    angles = np.arange(-60.0, 61.0, 10.0)
    ms = proj.tilt_matrices(angles, tilt_axis=0)
    mesh = _mesh4(dev)
    stacks = sharded_affine_batch(vol, ms, mesh=mesh, output="device")
    got = torch.cat(stacks)
    want = vt.StaticVolume(vol, device="cuda").affine_batch(
        ms, output="device")
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 3e-5
    p = proj.project(angles, tilt_axis=0, output="device")
    for mesh_shard in ("tilts", "volume"):
        res = wbp_reconstruct(p, ms, shape, mesh=mesh, mesh_shard=mesh_shard)
        one = wbp_reconstruct(p, ms, shape, device="cuda")
        assert np.abs(res - one).max() <= 1e-4 * np.abs(one).max()
    before = _build.launches()["partial_project"]
    before_line = _build.launches()["partial_project.line"]
    res = sirt_reconstruct(p, ms, shape, iterations=3, mesh=mesh)
    # D2 once per shard for the row sums and for each iteration's forward,
    # every launch on the line path (a tilt about array axis 2)
    assert _build.launches()["partial_project"] - before == 4 * (1 + 3)
    assert _build.launches()["partial_project.line"] - before_line == \
        4 * (1 + 3)
    one = sirt_reconstruct(p, ms, shape, iterations=3, device="cuda",
                           _plain_forward=True)
    assert np.abs(res - one).max() <= 1e-4 * np.abs(one).max()
    plain = sirt_reconstruct(p, ms, shape, iterations=3, mesh=mesh,
                             _plain_forward=True)
    assert np.abs(res - plain).max() <= 1e-4 * np.abs(plain).max()


@pytest.mark.parametrize("shape", [(40, 24, 28), (37, 20, 33)])
@pytest.mark.parametrize("mode,cval", [("constant", 0.0), ("border", 1.5)])
@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
def test_stream_body_equals_its_plain_version(dev, shape, mode, cval,
                                              interpolation):
    """The stream body on a 4-shard mesh through D1 (its ring entry, one
    launch a shard) equals its plain version on the card bit for bit (37
    planes pad to 40), for a full 3-D rotation, a half-voxel shift along z
    (every stencil straddles two planes, slab boundaries included) and a
    scale whose taps pass every edge."""
    from voltools_tpu_torch.parallel import ShardedVolume
    vol = np.random.default_rng(shape[0]).random(shape).astype(np.float32)
    center = tuple(s / 2 for s in shape)
    sv = ShardedVolume(vol, interpolation, mesh=_mesh4(dev), mode=mode,
                       cval=cval)
    for m in (transform_matrix(rotation=(111, -67, 148),
                               rotation_order="sxyz", center=center),
              translation_matrix((0.5, 0.25, -0.5)),
              transform_matrix(scale=(1.2, 0.85, 1.1), center=center)):
        m = np.asarray(m, np.float32)
        before = _build.launches()["partial_sample_ring"]
        got = sv._stream_body(m)
        assert _build.launches()["partial_sample_ring"] - before == 4
        want = sv._stream_body(m, plain=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.parametrize("shape", [(40, 36, 32), (37, 50, 61)])
@pytest.mark.parametrize("projection_axis", [0, 1, 2])
def test_partial_project_within_the_sum_order_bound(dev, shape,
                                                    projection_axis):
    """D2 against plain_partial_project on the card, per slab of a 4-shard
    split, on signed values: one launch for all tilts, within
    sum_order_atol of the plain projection of the slab's magnitudes (the
    two sum the same per-plane samples in two orders)."""
    rng = np.random.default_rng(sum(shape))
    center = tuple((s - 1) / 2 for s in shape)
    ms = np.stack([np.asarray(transform_matrix(
        rotation=tuple(rng.uniform(-180, 180, 3)), rotation_order="sxyz",
        center=center), np.float32) for _ in range(5)]
        + [np.asarray(transform_matrix(rotation=(a, 0, 0),
                                       rotation_order="rzxz", center=center),
                      np.float32) for a in (-60, 0, 45)])
    local = -(-shape[0] // 4)
    vol = np.zeros((4 * local,) + shape[1:], np.float32)
    vol[:shape[0]] = rng.standard_normal(shape)
    for i in range(4):
        x = torch.from_numpy(vol[i * local:(i + 1) * local].copy()).to(dev)
        off = float(np.float32(i * local))
        before = _build.launches()["partial_project"]
        got = partial_project(x, ms, off, shape, projection_axis)
        assert _build.launches()["partial_project"] - before == 1
        want = plain_partial_project(x, ms, off, shape, projection_axis)
        largest = float(plain_partial_project(x.abs(), ms, off, shape,
                                              projection_axis).max())
        err = float((got - want).abs().max())
        assert err <= sum_order_atol(shape[projection_axis], largest), err


@pytest.mark.parametrize("entry", ["ring", "steps"])
@pytest.mark.parametrize("shape", [(40, 24, 28), (37, 20, 33)])
@pytest.mark.parametrize("mode,cval", [("constant", 0.0), ("border", 1.5)])
@pytest.mark.parametrize("order", [1, 3])
def test_d1_entries_equal_the_plain_chain(dev, entry, shape, mode, cval,
                                          order):
    """Each shard of a 4-shard ring (37 planes pad to 40) through D1's ring
    entry (one launch) or its per-step entry chained over the same slabs
    in ring order (a launch a slab) equals the chain of plain steps on
    the card (plain_partial_ring) bit for bit: a full 3-D rotation, a
    half-voxel shift along z and a scale past every edge."""
    from voltools_tpu_torch.parallel.sharded import _shifted
    local = -(-shape[0] // 4)
    vol = np.zeros((4 * local,) + shape[1:], np.float32)
    vol[:shape[0]] = np.random.default_rng(sum(shape)).random(shape)
    slabs = [torch.from_numpy(vol[i * local:(i + 1) * local].copy()).to(dev)
             for i in range(4)]
    out_shape = (local,) + shape[1:]
    center = tuple(s / 2 for s in shape)
    for m in (transform_matrix(rotation=(111, -67, 148),
                               rotation_order="sxyz", center=center),
              translation_matrix((0.5, 0.25, -0.5)),
              transform_matrix(scale=(1.2, 0.85, 1.1), center=center)):
        for i in range(4):
            m_dev = _shifted(np.asarray(m, np.float32), np.float32(i * local))
            ring = [(i - k) % 4 for k in range(4)]
            z0s = [j * local for j in ring]
            before = _launched("partial_sample_ring", "partial_sample")
            if entry == "ring":
                got = partial_sample_ring([slabs[j] for j in ring], z0s,
                                          m_dev, shape, order, mode,
                                          out_shape, cval)
            else:
                got = torch.zeros(out_shape, device=dev)
                for k, j in enumerate(ring):
                    partial_sample(slabs[j], m_dev, z0s[k], shape, order,
                                   mode, got, k == 3, cval)
            assert tuple(np.subtract(_launched(
                "partial_sample_ring", "partial_sample"), before)) == (
                (1, 0) if entry == "ring" else (0, 4))
            want = plain_partial_ring([slabs[j] for j in ring], z0s, m_dev,
                                      shape, order, mode, out_shape, cval)
            assert torch.equal(got, want), float((got - want).abs().max())


def test_d1_ring_capacity(dev):
    """The kernel takes a ring of RING_CAPACITY slabs and refuses a longer
    one, as the wrapper does."""
    import ctypes
    m = np.eye(4, dtype=np.float32)
    slab = torch.zeros((2, 4, 4), device=dev)
    assert torch.equal(partial_sample_ring(
        [slab] * RING_CAPACITY, [2 * k for k in range(RING_CAPACITY)], m,
        (2 * RING_CAPACITY, 4, 4), 1, "constant", (2, 4, 4)),
        torch.zeros((2, 4, 4), device=dev))
    n = RING_CAPACITY + 1
    with pytest.raises(ValueError, match="at most"):
        partial_sample_ring([slab] * n, [0] * n, m, (2, 4, 4), 1, "constant",
                            (2, 4, 4))
    out = torch.empty((2, 4, 4), device=dev)
    # the C entry itself, past the wrapper's check: it fails the launch
    ring_entry = partial_library.launcher("partial_sample_ring_launch")
    with pytest.raises(RuntimeError, match="launch failed"):
        ring_entry(dev, (ctypes.c_void_p * n)(*[slab.data_ptr()] * n),
                   (ctypes.c_int * n)(), n, 2, 2, 4, 4,
                   np.ascontiguousarray(m[:3]).ctypes.data, out.data_ptr(),
                   2, 4, 4, 1, 0, 0.0)


def _single_axis_series(shape, order, position):
    center = tuple((s - 1) / 2 for s in shape)
    ms = []
    for a in np.arange(-60.0, 61.0, 3.0):
        triple = [0.0, 0.0, 0.0]
        triple[position] = float(a)
        ms.append(transform_matrix(rotation=triple, rotation_order=order,
                                   center=center))
    return np.stack(ms).astype(np.float32)


# (shape, projection axis, rotation order, position): the mesh SIRT's
# series, an odd shape, position 2, projection axis 1, and axis 2 (its
# line path runs along array axis 1)
LINE_CASES = [((40, 36, 32), 0, "rzxz", 0), ((37, 50, 61), 0, "rzxz", 0),
              ((36, 40, 32), 0, "rzxz", 2), ((38, 30, 34), 1, "rzxz", 0),
              ((30, 34, 40), 2, "sxyz", 1)]


@pytest.mark.parametrize("shape,projection_axis,order,position", LINE_CASES)
def test_partial_project_line_path(dev, shape, projection_axis, order,
                                   position):
    """D2 on a tilt series whose matrices leave the rays' second axis
    alone: the launch takes the line path (line_launches), equals the
    general kernel (_force_general) bit for bit per slab of a 4-shard
    split of signed values, and lies within sum_order_atol of the plain
    version."""
    ms = _single_axis_series(shape, order, position)
    keep = [a for a in range(3) if a != projection_axis]
    assert line_axis(ms, projection_axis) == keep[1]
    local = -(-shape[0] // 4)
    vol = np.zeros((4 * local,) + shape[1:], np.float32)
    vol[:shape[0]] = np.random.default_rng(sum(shape)).standard_normal(shape)
    for i in range(4):
        x = torch.from_numpy(vol[i * local:(i + 1) * local].copy()).to(dev)
        off = float(np.float32(i * local))
        before = _launched("partial_project", "partial_project.line")
        got = partial_project(x, ms, off, shape, projection_axis)
        general = partial_project(x, ms, off, shape, projection_axis,
                                  _force_general=True)
        assert tuple(np.subtract(_launched(
            "partial_project", "partial_project.line"), before)) == (2, 1)
        assert torch.equal(got, general), float((got - general).abs().max())
        want = plain_partial_project(x, ms, off, shape, projection_axis)
        largest = float(plain_partial_project(x.abs(), ms, off, shape,
                                              projection_axis).max())
        err = float((got - want).abs().max())
        assert err <= sum_order_atol(shape[projection_axis], largest), err


def _rotation_about(shape, axis, degrees):
    """The pull-back matrix of a rotation about array ``axis`` by
    ``degrees`` about the volume's centre."""
    i, j = [a for a in range(3) if a != axis]
    c, s = np.cos(np.radians(degrees)), np.sin(np.radians(degrees))
    m = np.eye(4)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    centre = (np.asarray(shape, np.float64) - 1) / 2
    m[:3, 3] = centre - m[:3, :3] @ centre
    return m


def _backprojection_case(shape, projection_axis, path, dev, seed):
    """(projections on ``dev``, float32 M^-1, keep) of 7 tilts about the
    column axis (row-gather) or about the row axis (general), the last
    tilt's rows shifted partly off the projection and one far off."""
    keep = [a for a in range(3) if a != projection_axis]
    about = keep[1] if path == "rowgather" else keep[0]
    minv = np.stack([np.linalg.inv(_rotation_about(shape, about, a))
                     for a in np.linspace(-60, 60, 7)]).astype(np.float32)
    minv[-1, keep[0], 3] += np.float32(0.4 * shape[keep[0]])
    minv[2, keep[0], 3] = np.float32(1e10)
    projs = torch.from_numpy(np.random.default_rng(seed).random(
        (7, shape[keep[0]], shape[keep[1]])).astype(np.float32)).to(dev)
    return projs, minv, keep


@pytest.mark.parametrize("shape", [(23, 29, 31), (1, 9, 10), (6, 1, 140)])
@pytest.mark.parametrize("projection_axis", [0, 1, 2])
@pytest.mark.parametrize("path", ["rowgather", "general"])
def test_backproject_equals_plain_version(dev, path, projection_axis, shape):
    """Both paths of C, bit for bit its plain version on the same card,
    on the whole volume and on a shard's slab-shifted matrices."""
    projs, minv, keep = _backprojection_case(shape, projection_axis, path,
                                             dev, seed=sum(shape))
    rowgather = path == "rowgather"
    if rowgather:
        assert row_gather(minv, keep, shape, tuple(projs.shape[1:]))
    # a shard's 3 planes from plane 2: the offset folded into column 3
    shifted = minv.copy()
    shifted[:, :, 3] += minv[:, :, 0] * np.float32(2)
    before = _build.launches()["backproject"]
    for mv, out_shape in ((minv, shape), (shifted, (3,) + shape[1:])):
        got = backproject(projs, mv, keep, out_shape, rowgather)
        assert got.is_cuda and got.shape == out_shape
        want = plain_backproject(projs, mv, keep, out_shape, rowgather)
        assert torch.equal(got, want), float((got - want).abs().max())
    assert _build.launches()["backproject"] == before + 2


def test_backproject_on_a_side_stream_and_the_last_card(dev):
    projs, minv, keep = _backprojection_case((12, 13, 14), 0, "rowgather",
                                             dev, seed=1)
    want = plain_backproject(projs, minv, keep, (12, 13, 14))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = backproject(projs, minv, keep, (12, 13, 14))
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(got, want)
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    got = backproject(projs.to(last), minv, keep, (12, 13, 14))
    assert torch.cuda.current_device() == 0 and got.device == last
    assert torch.equal(got.to(dev), want)
    with pytest.raises(ValueError, match="contiguous"):
        backproject(projs.transpose(1, 2), minv, keep, (12, 14, 13))


def test_reconstructions_launch_backproject_and_equal_its_plain_version(dev):
    """Every back-projection of WBP and SIRT, single-device and on a
    4-shard mesh, is one launch of C (a shard's one), and each result
    equals the same call with C's plain version bit for bit."""
    shape = (20, 22, 24)
    vol = np.random.default_rng(7).random(shape).astype(np.float32)
    proj = TiltSeriesProjector(vol, "linear", device="cuda")
    angles = np.arange(-60.0, 61.0, 20.0)
    ms = proj.tilt_matrices(angles, tilt_axis=0)
    p = proj.project(angles, tilt_axis=0, output="device")
    mesh = _mesh4(dev)
    calls = [
        (lambda **k: wbp_reconstruct(p, ms, shape, output="device", **k),
         1),
        (lambda **k: sirt_reconstruct(p, ms, shape, iterations=3,
                                      output="device", **k), 1 + 3),
        (lambda **k: wbp_reconstruct(p, ms, shape, mesh=mesh,
                                     mesh_shard="tilts", output="device",
                                     **k), 4),
        (lambda **k: torch.cat(wbp_reconstruct(
            p, ms, shape, mesh=mesh, mesh_shard="volume", output="device",
            **k)), 4),
        (lambda **k: torch.cat(sirt_reconstruct(
            p, ms, shape, iterations=3, mesh=mesh, output="device", **k)),
         4 * (1 + 3)),
    ]
    for call, launches in calls:
        before = _build.launches()["backproject"]
        got = call()
        assert _build.launches()["backproject"] == before + launches
        want = call(_plain_adjoint=True)
        assert _build.launches()["backproject"] == before + launches
        assert torch.equal(got, want)


def _tilt_case(shape, dev, seed, n=41, scale=1.0):
    """(projections on ``dev``, float32 M^-1) of the reconstruction's
    series about array axis 2 (projection axis 0, row-gather), ``n`` tilts
    from -60 to +60 degrees, the rows coordinate scaled by ``scale``."""
    minv = np.stack([np.linalg.inv(_rotation_about(shape, 2, a))
                     for a in np.linspace(-60, 60, n)]).astype(np.float32)
    minv[:, 1, :2] *= np.float32(scale)
    projs = torch.from_numpy(np.random.default_rng(seed).random(
        (n,) + shape[1:]).astype(np.float32)).to(dev)
    return projs, minv


@pytest.mark.parametrize("shape", [(37, 50, 61), (9, 16, 8), (13, 20, 300),
                                   (11, 9, 513)])
def test_backproject_tiles_equal_plain_at_ragged_shapes(dev, shape):
    """Shapes that are no multiple of the tile (4 x 8 lines, 256 columns),
    two and three column chunks: bit for bit the plain version, one launch
    a call, no window miss."""
    import voltools_tpu_torch.kernels.backproject as bp
    projs, minv = _tilt_case(shape, dev, seed=sum(shape), n=9)
    minv[3, 1, 3] += np.float32(0.4 * shape[1])     # partly off
    minv[5, 1, 3] = np.float32(-1e10)               # wholly off
    misses = bp.window_misses(dev)
    before = _build.launches()["backproject"]
    got = backproject(projs, minv, [1, 2], shape)
    assert _build.launches()["backproject"] == before + 1
    want = plain_backproject(projs, minv, [1, 2], shape, True)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert bp.window_misses(dev) == misses


def test_backproject_large_span_takes_a_small_tile(dev):
    """A scaled row-gather matrix: the first tile's window does not fit
    the shared memory, so the host picks a smaller tile; it stays on the
    row-gather kernel and stays right, with no window miss."""
    import voltools_tpu_torch.kernels.backproject as bp
    shape = (64, 250, 250)
    projs, minv = _tilt_case(shape, dev, seed=4, n=7, scale=30.0)
    table = bp.coefficients(minv, [1, 2], True)
    assert row_gather(minv, [1, 2], shape, tuple(projs.shape[1:]))
    tile = bp.rowgather_tile(table, shape[0], shape[1], shape[1])
    assert tile[:2] != bp.TILES[0]
    assert bp.smem_bytes(*tile) <= bp.SMEM_LIMIT
    misses = bp.window_misses(dev)
    got = backproject(projs, minv, [1, 2], shape)
    assert torch.equal(got, plain_backproject(projs, minv, [1, 2], shape,
                                              True))
    assert bp.window_misses(dev) == misses


def test_backproject_window_misses_are_counted_and_still_right(dev,
                                                               monkeypatch):
    """A window capped below what the tile needs: the taps outside it are
    read from global memory and counted, and the result stays right."""
    import voltools_tpu_torch.kernels.backproject as bp
    shape = (20, 30, 40)
    projs, minv = _tilt_case(shape, dev, seed=6, n=5)
    monkeypatch.setattr(bp, "rowgather_tile",
                        lambda *args: bp.RowTile(8, 8, 2))
    misses = bp.window_misses(dev)
    got = backproject(projs, minv, [1, 2], shape)
    assert torch.equal(got, plain_backproject(projs, minv, [1, 2], shape,
                                              True))
    assert bp.window_misses(dev) > misses


def test_backproject_no_window_miss_on_the_tilt_series(dev):
    """The reconstruction's 41-tilt series at 96^3 and a tomogram-like
    slab: every tap lies in its tile's window."""
    import voltools_tpu_torch.kernels.backproject as bp
    for shape in ((96, 96, 96), (32, 160, 160)):
        projs, minv = _tilt_case(shape, dev, seed=2)
        misses = bp.window_misses(dev)
        got = backproject(projs, minv, [1, 2], shape)
        assert torch.equal(got, plain_backproject(projs, minv, [1, 2],
                                                  shape, True))
        assert bp.window_misses(dev) == misses


def test_backproject_tiled_on_a_side_stream_and_the_last_card(dev):
    import voltools_tpu_torch.kernels.backproject as bp
    shape = (40, 70, 90)
    projs, minv = _tilt_case(shape, dev, seed=8, n=11)
    want = plain_backproject(projs, minv, [1, 2], shape, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = backproject(projs, minv, [1, 2], shape)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(got, want)
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    misses = bp.window_misses(last)
    got = backproject(projs.to(last), minv, [1, 2], shape)
    assert torch.cuda.current_device() == 0 and got.device == last
    assert torch.equal(got.to(dev), want)
    assert bp.window_misses(last) == misses


def test_backproject_build_reports_registers_without_spills(
        dev, tmp_path, monkeypatch):
    """A fresh build of C with the wrapper's layout: ptxas reports each
    row-gather instantiation within the registers of two 256-thread CTAs
    an SM, with no spill; a launch with the layout's shared memory runs."""
    import voltools_tpu_torch.kernels.backproject as bp
    from voltools_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build.build(bp.NAME, bp.LAYOUT)
    log = _build.BUILD_LOG[bp.NAME][1]
    for lines in (1, bp.LAYOUT["BP_LINES"]):
        regs, spill = _build.ptxas_usage(log, f"rowgather_kernelILi{lines}E")
        assert 0 < regs <= 128 and spill == 0, (lines, regs, spill)
    shape = (16, 24, 40)
    projs, minv = _tilt_case(shape, dev, seed=9, n=5)
    assert torch.equal(backproject(projs, minv, [1, 2], shape),
                       plain_backproject(projs, minv, [1, 2], shape, True))
