"""The port's planner: which launches the slab kernel takes, and its box rule.

``voltools_tpu_torch.kernels.planner.slab_plan`` gives a ``SlabPlan`` when
the source box of every (4, 8, 32) output brick of a launch fits the slab
kernel's per-buffer shared-memory budget and TMA's box (the box rule), and
``choose_plan`` / ``route`` when, besides, the slab kernel is the faster one
(the speed rule), else ``None`` (the walk kernel serves the launch).  The
box rule is checked on the matrices the kernel is for (tilt series,
translations, scales, shears) and on one it is not; the speed rule on the
tilt series and random rotations.

The box rule is held by a torch emulation of what ``csrc/affine_slab.cu``
does per work item: the box starts at floor(min over the brick's 8 corner
coordinates) + first tap - 1 and holds the plan's extents, x a multiple of
4, unclipped (TMA fills what lies outside the volume with zeros).  For every
output voxel inside the source, every tap index the kernel reads (after
mirror or clip) must lie in its brick's box and inside the volume (so no
filled zero is read), and the taps the brick's corners reach must fit the
plan's extents -- over axis-dominant matrices, shapes with extents down to
1, knife-edge translations and points at exactly n-1 (hypothesis).  The
coordinates are the plain version's, which the kernel computes bit for bit
(the same rounded operations in the same order).  A numpy emulation of the
kernel's persistent grid and its ring of box buffers checks that every
(brick, matrix) item is computed exactly once, from a box loaded for it."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

import os

from voltools_tpu_torch.kernels import _build
from voltools_tpu_torch.kernels.planner import (BRICK, MAX_BOX, SLAB_WINDOW,
                                                SLACK, SMEM_BUDGET, STAGES,
                                                SlabPlan, SlabWindow,
                                                choose_plan, route,
                                                slab_extents, slab_plan)
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
    """The box rule admits every 41-tilt envelope at 250^3 (the speed rule
    decides below whether it is the faster kernel for them)."""
    ms = tilt_series(axis, rotation_order)
    plan = slab_plan(ms, BIG, interpolation)
    assert isinstance(plan, SlabPlan)
    assert plan.smem_bytes <= SMEM_BUDGET and max(plan.extents) <= MAX_BOX
    assert STAGES * plan.smem_bytes < 227 * 1024
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
        assert slab_plan(m, BIG, interpolation, mode) is not None


def test_a_fully_mixing_rotation_takes_the_walk_kernel():
    m = transform_matrix(rotation=(45, 45, 45), rotation_order="rzxz",
                         center=CENTER)
    for interpolation, order in (("linear", 1), ("filt_bspline", 3)):
        assert choose_plan(m, BIG, interpolation) is None
        assert 4 * int(np.prod(slab_extents(m, BIG, order))) > SMEM_BUDGET
    # its box is over the budget: the box rule decides a trilinear batch;
    # one matrix, and cubic, which the slab kernel never takes, are
    # decided before any plan
    plan, rule, reason = route(np.stack([m, m]), BIG, "linear")
    assert plan is None and rule == "box" and "budget" in reason
    plan, rule, reason = route(m, BIG, "linear")
    assert plan is None and rule == "speed" and "outside" in reason
    plan, rule, reason = route(m, BIG, "filt_bspline")
    assert plan is None and rule == "speed" and "every box size" in reason
    # a milder one fits, and the speed rule decides: trilinear, one matrix
    # a launch, or a box of too many source voxels per output voxel, lies
    # outside the slab kernel's window; cubic takes no slab launch
    m = transform_matrix(rotation=(30, 20, 10), rotation_order="rzxz",
                         center=CENTER)
    for ms in (m, np.stack([m, m])):
        plan, rule, reason = route(ms, BIG, "linear")
        assert plan is None and rule == "speed" and "outside" in reason
    assert slab_plan(m, BIG, "linear").box_per_voxel > \
        SLAB_WINDOW[1].box_per_voxel
    assert SLAB_WINDOW[1].matrices > 1
    plan, rule, reason = route(m, BIG, "bspline")
    assert plan is None and rule == "speed" and "every box size" in reason
    assert slab_plan(m, BIG, "bspline") is not None


def test_extents_follow_the_span_rule():
    # identity: spans (7, 7, 31) from the (8, 8, 32) trilinear brick and
    # (3, 7, 31) from the (4, 8, 32) cubic one, + taps + 3; along x 3 more,
    # the most the kernel's rounding of the box's x origin down to a
    # multiple of 4 can add, then rounded up to 4 floats, TMA's row unit
    assert BRICK == {1: (8, 8, 32), 3: (4, 8, 32)} and SLACK == 3
    assert slab_extents(np.eye(4), BIG, 1) == (7 + 2 + 3, 7 + 2 + 3,
                                               31 + 2 + 3 + 3 + 1)
    assert slab_extents(np.eye(4), BIG, 3) == (3 + 4 + 3, 7 + 4 + 3,
                                               31 + 4 + 3 + 3 + 3)
    # not capped at the volume (TMA fills the outside with zeros), and a
    # brick no larger than the output
    assert slab_extents(np.eye(4), (5, 1, 20), 3) == (10, 7, 32)
    assert slab_extents(np.eye(4), BIG, 1, out_shape=(1, 2, 3)) == (5, 6, 12)
    # a scale stretches the span, a translation does not move it
    assert slab_extents(np.diag([2.0, 1, 1, 1]), BIG, 1)[0] == 14 + 2 + 3
    assert slab_extents(translation_matrix((0.3, 7.9, -4.4)), BIG, 1) == \
        slab_extents(np.eye(4), BIG, 1)
    # an empty stack needs no box; a non-finite matrix reads no tap and
    # gets the volume's extents
    assert slab_extents(np.zeros((0, 4, 4)), BIG, 1) == (1, 1, 4)
    bad = np.eye(4)
    bad[0, 1] = np.nan
    assert slab_extents(bad, (9, 10, 11), 1) == (9, 10, 12)
    assert slab_extents(np.eye(4), BIG, 1)[2] % 4 == 0


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        choose_plan(np.eye(4), BIG, "linear", mode="wrap")
    with pytest.raises(ValueError):
        choose_plan(np.eye(4), BIG, "cubic")
    with pytest.raises(ValueError):
        choose_plan(np.eye(3), BIG, "linear")


# ------------------------------------------------ the kernel's box rule

def kernel_boxes(matrix, vol_shape, out_shape, order):
    """Per brick, what ``affine_slab.cu`` works out for its box: the first
    voxel and the count its corners reach, per source axis, each
    (bricks_z, bricks_y, bricks_x), from the corner coordinates the kernel
    computes (clamped to +-1e9 before the floor, as the kernel), the x
    origin rounded down to a multiple of 4.  The kernel stages the plan's
    extents from the first voxel on, unclipped."""
    taps, first = (2, 0) if order == 1 else (4, -1)
    coords = affine_coords(out_shape, matrix)
    corner_idx = []
    for n, b in zip(out_shape, BRICK[order]):
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
        low = torch.floor(smin).long() + first - 1
        if a == 2:      # TMA reads rows from 16-byte boundaries
            low = low - low % 4
        high = torch.floor(smax).long() + first + taps
        lo.append(low)
        cnt.append(high - low + 1)
    return coords, lo, cnt


def assert_box_rule(matrix, vol_shape, out_shape, order, mode, extents):
    assert extents[2] % 4 == 0, extents
    coords, lo, cnt = kernel_boxes(matrix, vol_shape, out_shape, order)
    for a in range(3):
        assert int(cnt[a].max()) <= extents[a], (a, int(cnt[a].max()),
                                                 extents)
    taps, first = (2, 0) if order == 1 else (4, -1)
    # each voxel's brick
    grids = torch.meshgrid(*[torch.arange(n) // b for n, b in
                             zip(out_shape, BRICK[order])], indexing="ij")
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
        box_hi = box_lo + extents[a] - 1
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
            # TMA's zero fill lies outside the volume: no tap reads it
            outside_volume = (idx < 0) | (idx > n - 1)
            assert not bool((read & outside_volume).any()), (
                "a tap reads TMA's zero fill", a, k)


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


@settings(max_examples=60, deadline=None, database=None)
@given(angles=st.tuples(*[st.floats(-180.0, 180.0)] * 3),
       scale=st.tuples(*[st.floats(0.5, 2.0)] * 3),
       shift=st.tuples(offset, offset, offset),
       brick=st.tuples(st.integers(1, 8), st.integers(1, 8),
                       st.integers(1, 32)),
       start=st.tuples(*[st.integers(0, 200)] * 3))
def test_brick_corners_bound_every_voxels_floor(angles, scale, shift, brick,
                                               start):
    """The slab kernel skips the per-voxel box test where the box holds
    the taps of the brick's corners (affine_slab.cu's Origin::whole): each
    coordinate, rounded as the kernels round it, is monotone in u, v and w,
    so floor over the brick's voxels lies between floor over its corners'
    least and greatest coordinate."""
    m = np.asarray(rotation_matrix(angles, rotation_order="sxyz"),
                   np.float64) @ np.diag(list(scale) + [1.0])
    m[:3, 3] += shift
    m = torch.from_numpy(m.astype(np.float32))
    grids = [torch.arange(s, s + b, dtype=torch.float32)
             for s, b in zip(start, brick)]
    u, v, w = torch.meshgrid(*grids, indexing="ij")
    for a in range(3):
        # affine_coords' order: ((m0*u + m1*v) + m2*w) + m3, one rounding
        # per operation
        s = ((m[a, 0] * u + m[a, 1] * v) + m[a, 2] * w) + m[a, 3]
        corners = torch.stack([s[i, j, k] for i in (0, -1) for j in (0, -1)
                               for k in (0, -1)])
        assert torch.floor(s).min() >= torch.floor(corners.min())
        assert torch.floor(s).max() <= torch.floor(corners.max())


def test_slab_kernel_skips_the_box_test_only_for_whole_bricks():
    text = (_build.CSRC_DIR / "affine_slab.cu").read_text()
    flat = " ".join(text.split())
    assert ("const bool fits = last <= lo + (a == 0 ? e[0] : a == 1 ? e[1] "
            ": e[2]) - 1;") in flat
    assert "__all_sync(0xffffffffu, fits) ? 1 : 0};" in flat
    assert ("const int last = static_cast<int>(floorf(fminf(fmaxf(high, "
            "-kFar), kFar))) + kFirst + kTaps - 1;") in flat
    assert "bool in_box = true; if (!lo.whole) {" in flat


# ------------------------------------- the kernel's persistent schedule

def brick_of(item, n_bricks, bricks_y, bricks_x):
    """``affine_slab.cu``'s ``brick_of``: item -> (matrix, brick z, y, x)."""
    b, r = divmod(item, n_bricks)
    rest, bx = divmod(r, bricks_x)
    bz, by = divmod(rest, bricks_y)
    return b, bz, by, bx


def run_cta(items, stages):
    """One CTA's ring of ``stages`` box buffers over its ``items``, in the
    kernel's order: the loads of items 0 .. stages - 2, then per item k a
    barrier, the load of item k + stages - 1 into buffer (k + stages - 1)
    % stages, the wait on buffer k % stages at phase parity (k // stages)
    & 1, and the compute.  Checks that no load goes into a buffer whose
    item is not yet computed and that each wait finds its own item in its
    phase; returns the items computed."""
    held = [None] * stages      # the item whose box a buffer holds
    phases = [0] * stages       # loads into each buffer: its phases
    computed = []

    def load(k):
        if k >= len(items):
            return
        i = k % stages
        assert held[i] is None, "a load into a buffer still being read"
        held[i] = k
        phases[i] += 1

    for k in range(stages - 1):
        load(k)
    for k in range(len(items)):
        load(k + stages - 1)    # after the barrier: item k - 1 is computed
        i = k % stages
        # try_wait.parity((k // stages) & 1) passes once phase k // stages
        # of the buffer's barrier has completed: the load of item k
        assert held[i] == k and phases[i] - 1 == k // stages
        assert (phases[i] - 1) & 1 == (k // stages) & 1
        computed.append(items[k])
        held[i] = None
    return computed


@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("grid", [1, 7, 9, 13, 45, 90, 200])
def test_persistent_grid_computes_every_item_once(grid, stages):
    """(9, 17, 40) outputs of 5 matrices in cubic's (4, 8, 32) bricks:
    3 x 3 x 2 bricks each, 90 items; grids that do (1, 9, 45, 90) and do
    not (7, 13) divide them, and one larger than the items (the launch
    then takes one CTA per item)."""
    out_shape, n = (9, 17, 40), 5
    bricks = [-(-o // b) for o, b in zip(out_shape, BRICK[3])]
    n_bricks = int(np.prod(bricks))
    n_items = n * n_bricks
    grid = min(grid, n_items)
    seen = []
    for cta in range(grid):
        items = list(range(cta, n_items, grid))   # blockIdx.x + k * gridDim.x
        seen += [brick_of(it, n_bricks, bricks[1], bricks[2])
                 for it in run_cta(items, stages)]
    want = [(b, z, y, x) for b in range(n) for z in range(bricks[0])
            for y in range(bricks[1]) for x in range(bricks[2])]
    assert sorted(seen) == want
    # the CTAs that run at one time hold neighbouring bricks of one matrix
    if grid <= n_bricks:
        first_wave = [brick_of(c, n_bricks, bricks[1], bricks[2])
                      for c in range(grid)]
        assert {b for b, *_ in first_wave} == {0}


def test_schedule_matches_the_kernel_source():
    text = open(_build.CSRC_DIR / "affine_slab.cu").read()
    for line in ("const long long item = blockIdx.x + k * gridDim.x;",
                 "br.b = item / bricks;",
                 "const int bx = r % bricks_x;",
                 "const int by = rest % bricks_y;",
                 "for (int k = 0; k < stages - 1; ++k) {",
                 "load_item<ORDER>(k + stages - 1,",
                 "const int i = static_cast<int>(k % stages);",
                 "barrier_wait(&full[i], static_cast<uint32_t>((k / stages) "
                 "& 1));",
                 "cp.async.bulk.tensor.3d",
                 "const __grid_constant__ CUtensorMap map"):
        assert line in text, line
    assert (f"static constexpr int kBz = ORDER == 1 ? {BRICK[1][0]} : "
            f"{BRICK[3][0]};") in text
    assert f"static constexpr int kBy = {BRICK[1][1]};" in text
    assert BRICK[1][1] == BRICK[3][1]
    assert f"static constexpr int kBx = {BRICK[1][2]};" in text
    assert BRICK[1][2] == BRICK[3][2]
    assert f"constexpr int kMaxBox = {MAX_BOX};" in text


# ------------------------------------------------------- the speed rule

def bench_rotations(shape, n=16):
    """chip_smoke.py's (and bench.py's) random rotations: 'sxyz' about
    size/2, drawn from default_rng(0) after a 250^3 float64 volume (the
    generator advanced past it, not drawn)."""
    bits = np.random.PCG64(0)
    bits.advance(250 ** 3)
    rng = np.random.Generator(bits)
    center = tuple(s / 2 for s in shape)
    return np.stack([transform_matrix(rotation=tuple(rng.uniform(-180, 180,
                                                                 3)),
                                      rotation_order="sxyz", center=center)
                     for _ in range(n)]).astype(np.float32)


@pytest.mark.parametrize("shape", [(40, 48, 56), BIG])
def test_speed_rule_routes_each_set_to_the_faster_kernel(shape):
    """The picks PERF.md states for chip_smoke.py's matrix sets on the H100,
    at 250^3 and at the CPU tests' (40, 48, 56), where the bricks are whole
    and the boxes the same.  One matrix a launch, every set goes to the
    walk kernel in both orders.  As the paths launch them (the tilt series
    in chunks of 34 and 7, the random rotations in one launch), the slab
    kernel takes the chunks of the series about axis 0 trilinear (4.39 box
    voxels per output voxel, where it is within 5% of the walk kernel) and
    nothing else; the reasons say why."""
    tilt = tilt_series(1, "rzxz", shape)
    recon = tilt_series(0, "rzxz", shape)
    rots = bench_rotations(shape)
    assert sum(slab_plan(m, shape, "bspline") is not None
               for m in rots) == 13
    for interpolation in ("linear", "bspline"):
        for ms in (tilt, recon, rots):
            for m in ms:
                plan, rule, reason = route(m, shape, interpolation)
                assert plan is None
                assert rule == "box" or "outside" in reason or (
                    "every box size" in reason)
        # the box rule admits the tilt series as single launches: the
        # speed rule decides those
        assert all(route(m, shape, interpolation).rule == "speed"
                   for m in tilt)
    for chunk in (slice(0, 34), slice(34, 41)):
        plan, rule, reason = route(recon[chunk], shape, "linear")
        assert plan is not None and rule == "speed" and "inside" in reason
        assert plan.box_per_voxel == pytest.approx(4.3945, abs=1e-3)
        assert choose_plan(recon[chunk], shape, "bspline") is None
        for interpolation in ("linear", "bspline"):
            assert choose_plan(tilt[chunk], shape, interpolation) is None
    for interpolation in ("linear", "bspline"):
        assert choose_plan(rots, shape, interpolation) is None
    # the window: trilinear launches of at least 2 matrices and at most
    # 4.5 box voxels per output voxel; cubic none
    assert SLAB_WINDOW == {1: SlabWindow(2, 4.5), 3: None}
