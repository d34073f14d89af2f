"""The port's planner: which launches the slab kernel takes, and its box rule.

``voltools_tpu_torch.kernels.planner.choose_plan`` gives a ``SlabPlan`` when
the source box of every (4, 8, 32) output brick of a launch fits the slab
kernel's shared-memory budget, else ``None`` (the walk kernel serves the
launch).  The routing is checked on the matrices the kernel is for (tilt
series, translations, scales, shears) and on one it is not.

The box rule is held by a torch emulation of what ``csrc/affine_slab.cu``
does per CTA: the box from the brick's 8 corner coordinates, widened by the
taps and one voxel of slack each side and clipped to the volume.  For every
output voxel inside the source, every tap index the kernel reads (after
mirror or clip) must lie in its brick's box, and every box must fit the
plan's extents -- over axis-dominant matrices, shapes with extents down to
1, knife-edge translations and points at exactly n-1 (hypothesis).  The
coordinates are the plain version's, which the kernel computes bit for bit
(the same rounded operations in the same order)."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from voltools_tpu_torch.kernels.planner import (BRICK, SLACK, SMEM_BUDGET,
                                                SlabPlan, choose_plan,
                                                slab_extents)
from voltools_tpu_torch.ops.interpolation import _mirror_index
from voltools_tpu_torch.ops.sampling import affine_coords
from voltools_tpu_torch.utils import (rotation_matrix, transform_matrix,
                                      translation_matrix)

BIG = (250, 250, 250)
CENTER = tuple((s - 1) / 2 for s in BIG)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tilt_series(axis, rotation_order, shape=BIG):
    """41 tilts from -60 to +60 degrees about the volume's center, as
    ``TiltSeriesProjector.tilt_matrices`` builds them."""
    center = np.divide(np.subtract(shape, 1), 2, dtype=np.float32)
    ms = []
    for a in np.arange(-60.0, 61.0, 3.0):
        triple = [0.0, 0.0, 0.0]
        triple[axis] = a
        ms.append(transform_matrix(rotation=triple,
                                   rotation_order=rotation_order,
                                   center=center))
    return np.stack(ms).astype(np.float32)


@pytest.mark.parametrize("rotation_order", ["rzxz", "sxyz"])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
def test_tilt_series_envelopes_take_the_slab_kernel(rotation_order, axis,
                                                    interpolation):
    ms = tilt_series(axis, rotation_order)
    plan = choose_plan(ms, BIG, interpolation)
    assert isinstance(plan, SlabPlan)
    assert plan.smem_bytes <= SMEM_BUDGET
    assert plan.order == (1 if interpolation == "linear" else 3)
    assert plan.vol_shape == plan.out_shape == BIG
    # the envelope covers every tilt: no single tilt needs more
    for m in ms[::8]:
        own = slab_extents(m, BIG, plan.order)
        assert all(a <= b for a, b in zip(own, plan.extents))


@pytest.mark.parametrize("mode", ["constant", "border"])
@pytest.mark.parametrize("interpolation", ["linear", "bspline"])
def test_local_transforms_take_the_slab_kernel(interpolation, mode):
    for m in (np.eye(4), translation_matrix((1.5, -2.25, 0.75)),
              transform_matrix(scale=(1.3, 0.8, 1.1), center=CENTER),
              transform_matrix(shear=(0.1, -0.05, 0.2), center=CENTER)):
        assert choose_plan(m, BIG, interpolation, mode) is not None


def test_a_fully_mixing_rotation_takes_the_walk_kernel():
    m = transform_matrix(rotation=(45, 45, 45), rotation_order="rzxz",
                         center=CENTER)
    assert choose_plan(m, BIG, "filt_bspline") is None
    extents = slab_extents(m, BIG, 3)
    assert 4 * int(np.prod(extents)) > SMEM_BUDGET


def test_extents_follow_the_span_rule():
    # identity: spans (3, 7, 31) from the (4, 8, 32) brick
    assert BRICK == (4, 8, 32) and SLACK == 3
    assert slab_extents(np.eye(4), BIG, 1) == (3 + 2 + 3, 7 + 2 + 3,
                                               31 + 2 + 3)
    assert slab_extents(np.eye(4), BIG, 3) == (3 + 4 + 3, 7 + 4 + 3,
                                               31 + 4 + 3)
    # capped at the volume, and a brick no larger than the output
    assert slab_extents(np.eye(4), (5, 1, 20), 3) == (5, 1, 20)
    assert slab_extents(np.eye(4), BIG, 1, out_shape=(1, 2, 3)) == (5, 6, 7)
    # a scale stretches the span, a translation does not move it
    assert slab_extents(np.diag([2.0, 1, 1, 1]), BIG, 1)[0] == 6 + 2 + 3
    assert slab_extents(translation_matrix((0.3, 7.9, -4.4)), BIG, 1) == \
        slab_extents(np.eye(4), BIG, 1)
    # an empty stack needs no box; a non-finite matrix the whole volume
    assert slab_extents(np.zeros((0, 4, 4)), BIG, 1) == (1, 1, 1)
    bad = np.eye(4)
    bad[0, 1] = np.nan
    assert slab_extents(bad, (9, 10, 11), 1) == (9, 10, 11)


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        choose_plan(np.eye(4), BIG, "linear", mode="wrap")
    with pytest.raises(ValueError):
        choose_plan(np.eye(4), BIG, "cubic")
    with pytest.raises(ValueError):
        choose_plan(np.eye(3), BIG, "linear")


# ------------------------------------------------ the kernel's box rule

def kernel_boxes(matrix, vol_shape, out_shape, order):
    """Per brick, the box ``affine_slab.cu`` stages: (lo, count) per source
    axis, each (bricks_z, bricks_y, bricks_x), from the corner coordinates
    the kernel computes (clamped to +-1e9 before the floor, as the
    kernel)."""
    taps, first = (2, 0) if order == 1 else (4, -1)
    coords = affine_coords(out_shape, matrix)
    corner_idx = []
    for n, b in zip(out_shape, BRICK):
        u0 = torch.arange(0, n, b)
        u1 = torch.clamp(u0 + b, max=n) - 1
        corner_idx.append(torch.stack([u0, u1]))          # (2, bricks)
    u, v, w = corner_idx
    lo, cnt = [], []
    for a, n in enumerate(vol_shape):
        s = coords[a][u[:, :, None, None, None, None],
                      v[None, None, :, :, None, None],
                      w[None, None, None, None, :, :]]
        # (2, bz, 2, by, 2, bx) -> min and max over the 8 corners
        s = s.permute(1, 3, 5, 0, 2, 4).reshape(s.shape[1], s.shape[3],
                                                 s.shape[5], 8)
        smin = s.min(dim=-1).values.clamp(-1e9, 1e9)
        smax = s.max(dim=-1).values.clamp(-1e9, 1e9)
        low = torch.clamp(torch.floor(smin).long() + first - 1, min=0)
        high = torch.clamp(torch.floor(smax).long() + first + taps,
                           max=n - 1)
        lo.append(low)
        cnt.append(torch.clamp(high - low + 1, min=0))
    return coords, lo, cnt


def assert_box_rule(matrix, vol_shape, out_shape, order, mode, extents):
    coords, lo, cnt = kernel_boxes(matrix, vol_shape, out_shape, order)
    for a in range(3):
        assert int(cnt[a].max()) <= extents[a], (a, int(cnt[a].max()),
                                                 extents)
    taps, first = (2, 0) if order == 1 else (4, -1)
    # each voxel's brick
    grids = torch.meshgrid(*[torch.arange(n) // b for n, b in
                             zip(out_shape, BRICK)], indexing="ij")
    if mode == "constant":
        inside = torch.ones(out_shape, dtype=torch.bool)
        for a, n in enumerate(vol_shape):
            inside &= (coords[a] >= 0) & (coords[a] <= n - 1)
    else:
        inside = torch.ones(out_shape, dtype=torch.bool)
        for a, n in enumerate(vol_shape):
            inside &= (coords[a] > -0.5) & (coords[a] < n - 0.5)
    for a, n in enumerate(vol_shape):
        base = torch.floor(coords[a]).long() + first
        box_lo = lo[a][grids]
        box_hi = box_lo + cnt[a][grids] - 1
        for k in range(taps):
            i = base + k
            if mode == "constant" and order == 3:
                idx, read = _mirror_index(i, n), inside
            elif mode == "constant":
                idx, read = i.clamp(0, n - 1), inside
            else:   # 'border' reads only the taps inside [0, n)
                idx, read = i, inside & (i >= 0) & (i < n)
            outside_box = (idx < box_lo) | (idx > box_hi)
            assert not bool((read & outside_box).any()), (
                "a tap outside its brick's box", a, k)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("mode", ["constant", "border"])
def test_box_rule_on_tilts_and_points_at_the_edge(order, mode):
    shape = (13, 21, 40)
    center = tuple((s - 1) / 2 for s in shape)
    cases = [np.eye(4),
             # every point at exactly n-1 along z, and along all three
             translation_matrix((12.0, 0.0, 0.0)),
             np.diag([0.0, 0.0, 0.0, 1.0]) + translation_matrix(
                 (12.0, 20.0, 39.0)) - np.eye(4),
             translation_matrix((1 - 1e-7, -2 + 1e-7, 3e-8)),
             transform_matrix(rotation=(0, 35, 0), rotation_order="rzxz",
                              center=center),
             transform_matrix(rotation=(170, 0, 0), rotation_order="rzxz",
                              center=center)]
    for m in cases:
        m = np.asarray(m, np.float32)
        extents = slab_extents(m, shape, order)
        assert_box_rule(m, shape, shape, order, mode, extents)
    envelope = tilt_series(1, "rzxz", shape)
    extents = slab_extents(envelope, shape, order)
    for m in envelope[::5]:
        assert_box_rule(m, shape, shape, order, mode, extents)


extent = st.sampled_from([1, 2, 3, 5, 8, 9, 17, 33])
angle = st.floats(-25.0, 25.0)
offset = st.one_of(
    st.floats(-6.0, 6.0),
    # knife edges: an integer, or an integer off by a rounding or two
    st.builds(lambda k, e: k + e, st.integers(-4, 4),
              st.sampled_from([0.0, 1e-7, -1e-7, 3e-6, -3e-6, 0.5])))


@settings(max_examples=40, deadline=None, database=None)
@given(shape=st.tuples(extent, extent, extent),
       out=st.one_of(st.none(), st.tuples(extent, extent, extent)),
       angles=st.tuples(angle, angle, angle),
       single_axis=st.booleans(),
       big_angle=st.floats(-180.0, 180.0),
       scale=st.tuples(*[st.floats(0.7, 1.3)] * 3),
       shear=st.floats(-0.2, 0.2),
       shift=st.tuples(offset, offset, offset),
       edge=st.booleans(),
       order=st.sampled_from([1, 3]),
       mode=st.sampled_from(["constant", "border"]))
def test_every_tap_lies_in_its_bricks_box(shape, out, angles, single_axis,
                                          big_angle, scale, shear, shift,
                                          edge, order, mode):
    """Axis-dominant matrices: a small 3-D rotation, or one axis at any
    angle, with a scale, a shear and a translation; or a pure translation
    that puts points at exactly n-1."""
    out = shape if out is None else out
    if edge:
        m = translation_matrix(tuple(float(n - 1 - k) for n, k in
                                     zip(shape, (0, 1, 2))))
    else:
        rot = (rotation_matrix((big_angle, 0.0, 0.0), rotation_order="rzxz")
               if single_axis else
               rotation_matrix(angles, rotation_order="sxyz"))
        m = np.asarray(rot, np.float64) @ np.diag(list(scale) + [1.0])
        m[0, 1] += shear
        m[:3, 3] += shift
    m = np.asarray(m, np.float32)
    extents = slab_extents(m, shape, order, out)
    assert_box_rule(m, shape, out, order, mode, extents)
