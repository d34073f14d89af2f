"""The slab kernel's row path: trilinear launches whose every matrix leaves
the row axis (array axis 2) alone.

``kernels/planner.py::route`` gives such a launch of two or more matrices
a row plan (``SlabPlan.rows``, rule 'rows'), and
``kernels/affine_slab.py::affine_slab`` launches the row kernel of
``csrc/affine_slab.cu`` for it: each output row the bilinear mix of four
whole source rows, no box.

On the CPU (tier 1): which launches the planner marks, the route's rule
and reason, the one home of ``_leaves_alone``, the wrapper's checks of a
row plan, launches whose general box is over TMA's served as before, and
the route counter.

On the card (skipped without CUDA; ``tests/conftest.py`` imports JAX, so
on a machine without it run::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_slab_rows.py -q

): the row path bit for bit the general kernel (``_force_general``) on a
finite volume and within ATOL of the plain version, in both item orders,
where a non-finite voxel parts them, matrices off the row rule resampled
and counted, and its launch counter."""

import inspect
import pathlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from portbench.traffic import tilt_series as cell_tilt_series
from voltools_tpu_torch import transforms as tvt
from voltools_tpu_torch.kernels import partial_sample, planner
from voltools_tpu_torch.kernels.affine_slab import affine_slab
from voltools_tpu_torch.kernels.planner import (ROW_AXIS, SlabPlan,
                                                _leaves_alone, route,
                                                slab_plan)
from voltools_tpu_torch.models import TiltSeriesProjector
from voltools_tpu_torch.ops.sampling import affine_sample
from voltools_tpu_torch.utils import trace, transform_matrix

ANGLES = np.arange(-60.0, 61.0, 3.0)
TOMO = (256, 512, 512)
ATOL = 5e-5
PACKAGE = pathlib.Path(planner.__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def about_axis(axis, angles, shape):
    """Rotations by ``angles`` (degrees) about array axis ``axis`` through
    the center (n - 1) / 2 of ``shape``: (N, 4, 4) float32."""
    c = (np.asarray(shape, np.float64) - 1) / 2
    ms = []
    for a in np.deg2rad(np.asarray(angles, np.float64)):
        r = np.eye(3)
        p, q = [x for x in range(3) if x != axis]
        r[p, p] = r[q, q] = np.cos(a)
        r[p, q], r[q, p] = -np.sin(a), np.sin(a)
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = c - r @ c
        ms.append(m)
    return np.stack(ms).astype(np.float32)


def projector_tilts(shape, tilt_axis, angles=ANGLES):
    vol = np.zeros(shape, np.float32)
    return TiltSeriesProjector(vol, "linear", rotation_order="rzxz",
                               device="cpu").tilt_matrices(angles,
                                                           tilt_axis)


# ------------------------------------------------------------ the planner

@pytest.mark.parametrize("source", ["cell", "projector", "about_axis_2"])
@pytest.mark.parametrize("shape", [TOMO, (250, 250, 250), (37, 50, 61)])
@pytest.mark.parametrize("chunk", [slice(0, 2), slice(0, 8), slice(0, 41)])
def test_tilt_series_about_axis_2_are_row_launches(source, shape, chunk):
    """The benchmark's tilt series, the projector's with the angle at
    position 0 of 'rzxz', and rotations about array axis 2 leave the row
    axis alone: launches of 2, 8 and 41 of them take the row path."""
    ms = {"cell": lambda: cell_tilt_series(ANGLES, shape),
          "projector": lambda: projector_tilts(shape, 0),
          "about_axis_2": lambda: about_axis(2, ANGLES, shape)}[source]()
    ms = ms[chunk]
    assert _leaves_alone(ms, ROW_AXIS)
    for mode in ("constant", "border"):
        plan, rule, reason = route(ms, shape, "linear", mode)
        assert rule == "rows" and isinstance(plan, SlabPlan) and plan.rows
        assert (plan.order, plan.mode, plan.vol_shape, plan.out_shape) == (
            1, mode, shape, shape)
        # the plan keeps the general kernel's box, for _force_general
        assert plan.extents == slab_plan(ms, shape, "linear", mode).extents


def _random_rotations(shape, n=8):
    rng = np.random.default_rng(7)
    c = tuple(s / 2 for s in shape)
    return np.stack([transform_matrix(
        rotation=tuple(rng.uniform(-180, 180, 3)), rotation_order="sxyz",
        center=c) for _ in range(n)]).astype(np.float32)


def _x_row(kind, shape):
    ms = cell_tilt_series(ANGLES[:8], shape)
    if kind == "x_translation":
        ms[3, 2, 3] = 0.5
    elif kind == "x_scale":
        ms[5, 2, 2] = 1.25
    elif kind == "x_one_ulp":
        ms[0, 2, 2] = np.nextafter(np.float32(1), np.float32(2))
    elif kind == "x_into_y":
        ms[1, 1, 2] = 1e-3
    return ms


@pytest.mark.parametrize("case", [
    "random", "about_axis_0", "about_axis_1", "projector_tilt_axis_1",
    "x_translation", "x_scale", "x_one_ulp", "x_into_y", "cubic",
    "single"])
def test_other_launches_are_planned_as_before(case):
    """Random rotations, tilts about array axis 0 or 1, a row-2 translation
    or scale (or a column-2 entry) on one matrix of a series, a cubic
    launch and a single matrix are not row launches: each is routed as
    before the row rule, by the speed or the box rule."""
    shape = (40, 48, 56)
    interpolation = "bspline" if case == "cubic" else "linear"
    ms = {"random": lambda: _random_rotations(shape),
          "about_axis_0": lambda: about_axis(0, ANGLES, shape),
          "about_axis_1": lambda: about_axis(1, ANGLES, shape),
          "projector_tilt_axis_1": lambda: projector_tilts(shape, 1),
          "cubic": lambda: cell_tilt_series(ANGLES, shape),
          "single": lambda: cell_tilt_series(ANGLES, shape)[:1],
          }.get(case, lambda: _x_row(case, shape))()
    if case not in ("cubic", "single"):
        assert not _leaves_alone(ms, ROW_AXIS)
    plan, rule, reason = route(ms, shape, interpolation)
    assert rule in ("speed", "box") and "row path" not in reason
    assert plan is None or not plan.rows
    if case in ("about_axis_0", "x_translation", "x_scale", "x_one_ulp",
                "x_into_y"):
        # the box rule admits them, and the general kernel's speed rule
        # decides as it did
        general = slab_plan(ms, shape, interpolation)
        assert general is not None and rule == "speed"
        window = planner.SLAB_WINDOW[1]
        assert (plan is not None) == (general.box_per_voxel
                                      <= window.box_per_voxel)


def test_single_matrix_calls_skip_the_row_test(monkeypatch):
    """A launch under the speed rule's window (one matrix: every call of
    a StaticVolume.affine sweep) returns before the row test runs."""
    calls = []
    monkeypatch.setattr(planner, "_leaves_alone",
                        lambda *a: calls.append(a) or True)
    ms = cell_tilt_series(ANGLES, (40, 48, 56))
    assert route(ms[0], (40, 48, 56), "linear").rule == "speed"
    assert route(ms[:1], (40, 48, 56), "linear").rule == "speed"
    assert route(ms, (40, 48, 56), "bspline").rule == "speed"
    assert not calls
    assert route(ms, (40, 48, 56), "linear").rule == "rows"
    assert len(calls) == 1


def test_route_reason_and_last_dispatch_name_the_row_path():
    shape = (18, 20, 22)
    ms = projector_tilts(shape, 0, ANGLES[::10])
    plan, rule, reason = route(ms, shape, "linear")
    assert rule == "rows"
    assert reason.startswith(f"{len(ms)} matrices that leave the row axis "
                             f"alone")
    assert "row path" in reason and "no box" in reason
    vol = np.random.default_rng(1).random(shape).astype(np.float32)
    tp = TiltSeriesProjector(vol, "linear", device="cpu")
    tp.project(ANGLES[::10], tilt_axis=0)
    info = tvt.last_dispatch()
    assert info["rule"] == "rows" and info["variant"].rows
    assert "slab kernel (affine_slab) by the rows rule" in info["reason"]
    tp.project(ANGLES[::10], tilt_axis=1)
    assert tvt.last_dispatch()["rule"] != "rows"


def test_leaves_alone_has_one_home():
    """``_leaves_alone`` is defined in the planner alone; kernel D's line
    path imports it from there."""
    assert partial_sample._leaves_alone is planner._leaves_alone
    assert inspect.getmodule(planner._leaves_alone) is planner
    homes = [p.relative_to(PACKAGE).as_posix()
             for p in sorted(PACKAGE.rglob("*.py"))
             if "def _leaves_alone(" in p.read_text()]
    assert homes == ["kernels/planner.py"]


def test_route_counter_counts_row_launches():
    shape = (18, 20, 22)
    vol = np.random.default_rng(2).random(shape).astype(np.float32)
    tp = TiltSeriesProjector(vol, "linear", device="cpu")
    before = trace.counts()
    tp.project(ANGLES[::10], tilt_axis=0)      # the tracer off: no count
    trace.start()
    try:
        tp.project(ANGLES[::10], tilt_axis=0)
        tp.project(ANGLES[::10], tilt_axis=1)
        after = trace.counts()
    finally:
        trace.stop()
    assert after.get("route.kernel_b.rows", 0) - before.get(
        "route.kernel_b.rows", 0) == 1
    # the CPU path launches nothing
    assert after["launches.affine_slab.rows"] == before[
        "launches.affine_slab.rows"] == affine_slab.row_launches


# --------------------------------------------- the wrapper on the CPU

def test_wrapper_checks_a_row_plan():
    shape = (12, 14, 18)
    vol = torch.from_numpy(np.random.default_rng(3).random(shape).astype(
        np.float32))
    ms = cell_tilt_series(ANGLES[::8], shape)
    plan = route(ms, shape, "linear").plan
    assert plan.rows
    got = affine_slab(vol, torch.from_numpy(ms), 1, plan=plan)
    for i, m in enumerate(ms):
        assert torch.equal(got[i], affine_sample(
            vol, torch.from_numpy(m), "linear", "constant", 0.0,
            prefiltered=True))
    # matrices that do not leave the row axis alone, or a cubic call,
    # refuse a row plan
    rots = _random_rotations(shape, 2)
    rot_plan = SlabPlan(1, "constant", shape, shape,
                        planner.slab_extents(rots, shape, 1), rows=True)
    with pytest.raises(ValueError, match="leave axis 2 alone"):
        affine_slab(vol, torch.from_numpy(rots), 1, plan=rot_plan)
    cubic = SlabPlan(3, "constant", shape, shape,
                     planner.slab_extents(ms, shape, 3), rows=True)
    with pytest.raises(ValueError, match="trilinear"):
        affine_slab(vol, torch.from_numpy(ms), 3, plan=cubic)


def _over_tma(case, shape):
    """Two matrices that leave the row axis alone and whose general box
    is over TMA's 256 voxels along z and y: a (z, y) scale of 40, or a NaN
    in row 0 (whose box slab_extents makes the whole volume)."""
    ms = cell_tilt_series(ANGLES[:2], shape)
    if case == "scale_40":
        ms = np.stack([np.diag([40.0, 40.0, 1.0, 1.0])] * 2).astype(
            np.float32)
    else:
        ms[0, 0, 0] = np.nan
    return ms


@pytest.mark.parametrize("case", ["scale_40", "nan_in_row_0"])
def test_boxes_over_tma_are_served_as_before(case):
    """A row launch whose general box TMA could not take (the box rule
    sent it to the walk kernel before the row rule) is served: the row
    path stages no box, so its plan's extents are not checked, and on the
    CPU the answer is the plain sampler's."""
    from voltools_tpu_torch.volume import StaticVolume
    shape = (300, 300, 12)
    ms = _over_tma(case, shape)
    plan, rule, _ = route(ms, shape, "linear")
    assert rule == "rows" and max(plan.extents) > planner.MAX_BOX
    vol = np.random.default_rng(5).random(shape).astype(np.float32)
    got = StaticVolume(vol, "linear", device="cpu").affine_batch(ms)
    assert tvt.last_dispatch()["rule"] == "rows"
    for i, m in enumerate(ms):
        want = affine_sample(torch.from_numpy(vol), torch.from_numpy(m),
                             "linear", "constant", 0.0, prefiltered=True)
        assert torch.equal(torch.as_tensor(got[i]), want)
    # the general kernel cannot take that box
    with pytest.raises(ValueError, match="TMA takes boxes"):
        affine_slab(torch.from_numpy(vol), torch.from_numpy(ms), 1,
                    plan=plan, _force_general=True)


# ----------------------------------------------------------- the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rows_equal_general(dev, shape, ms, mode="constant", cval=0.0,
                        out_shape=None, plain_every=None):
    """The row path's launch over ``ms`` against the general kernel's
    (``_force_general``) with the same plan, bit for bit, and against the
    plain version within ATOL on every ``plain_every``-th matrix."""
    from voltools_tpu_torch.kernels.layout import pitched
    out_shape = tuple(out_shape or shape)
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    vol = pitched(torch.rand(shape, generator=gen, device=dev))
    plan = route(ms, shape, "linear", mode, out_shape).plan
    assert plan is not None and plan.rows
    ms_dev = torch.from_numpy(ms).to(dev)
    before = (affine_slab.launches, affine_slab.row_launches)
    got = affine_slab(vol, ms_dev, 1, mode, cval, out_shape, plan=plan)
    want = affine_slab(vol, ms_dev, 1, mode, cval, out_shape, plan=plan,
                       _force_general=True)
    assert (affine_slab.launches - before[0],
            affine_slab.row_launches - before[1]) == (2, 1)
    assert torch.equal(got, want)
    for i in range(0, len(ms), plain_every or len(ms)):
        torch.testing.assert_close(got[i], affine_sample(
            vol, ms_dev[i], "linear", mode, cval, out_shape=out_shape,
            prefiltered=True), atol=ATOL, rtol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("mode,cval", [("constant", 0.0),
                                       ("constant", 1.5),
                                       ("border", 0.0), ("border", 1.5)])
@pytest.mark.parametrize("shape,out_shape", [
    ((37, 50, 61), None), ((40, 48, 56), (33, 52, 70)),
    ((40, 48, 56), (44, 30, 29)), ((1, 9, 10), None)])
@pytest.mark.parametrize("n", [2, 8, 41])
def test_rows_equal_the_general_kernel(dev, mode, cval, shape, out_shape,
                                       n):
    """Both edges, widths not a multiple of 4, an output shape other than
    the volume's, launches of 2, 8 and 41 tilts."""
    ms = cell_tilt_series(ANGLES, shape)[:n]
    _rows_equal_general(dev, shape, ms, mode, cval, out_shape,
                        plain_every=7)


def _rows_in_order(vol, ms_dev, item_order, out_shape=None):
    """The row path's launch through its C entry, its CTAs numbered in
    ``item_order`` (1: x segment first, 0: matrix first), 'constant'."""
    from voltools_tpu_torch.kernels import affine_slab as slab_module
    from voltools_tpu_torch.kernels.layout import row_pitch
    out_shape = tuple(out_shape or vol.shape)
    out = torch.empty((len(ms_dev),) + out_shape, device=vol.device)
    code = slab_module._library().affine_rows_launch(
        vol.data_ptr(), *vol.shape, row_pitch(vol), ms_dev.data_ptr(),
        len(ms_dev), out.data_ptr(), *out_shape, 0, 0.0, item_order,
        slab_module._counter(vol.device).data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert code == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("item_order", [1, 0])
def test_rows_at_the_tomogram_shape(dev, item_order):
    """The benchmark's (256, 512, 512) volume in the forward's launch of
    8 tilts, both item orders, bit for bit the general kernel."""
    from voltools_tpu_torch.kernels.layout import pitched
    ms = cell_tilt_series(ANGLES, TOMO)[16:24]
    vol = pitched(torch.rand(TOMO, device=dev))
    plan = route(ms, TOMO, "linear").plan
    ms_dev = torch.from_numpy(ms).to(dev)
    got = _rows_in_order(vol, ms_dev, item_order)
    want = affine_slab(vol, ms_dev, 1, plan=plan, _force_general=True)
    assert torch.equal(got, want)
    torch.testing.assert_close(got[3], affine_sample(
        vol, ms_dev[3], "linear", "constant", 0.0, prefiltered=True),
        atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("item_order", [1, 0])
@pytest.mark.parametrize("bad", ["one", "all"])
def test_matrices_off_the_row_rule_are_resampled_and_counted(dev, bad,
                                                             item_order):
    """A row plan whose matrices on the card do not all leave the row axis
    alone (the wrapper does not read them back): those matrices are
    resampled as the walk kernel does, bit for bit, and their voxels are
    counted in overflows(); the others stay on the row path."""
    from voltools_tpu_torch.kernels import affine_slab as slab_module
    from voltools_tpu_torch.kernels.affine_resample import affine_resample
    from voltools_tpu_torch.kernels.layout import pitched
    shape = (37, 50, 61)
    ms = cell_tilt_series(ANGLES, shape)[:8]
    plan = route(ms, shape, "linear").plan
    rots = _random_rotations(shape, 8)
    if bad == "one":
        ms[3] = rots[3]
        n_bad = 1
    else:
        ms = rots
        n_bad = len(ms)
    vol = pitched(torch.rand(shape, device=dev))
    ms_dev = torch.from_numpy(ms).to(dev)
    before = slab_module.overflows(dev)
    got = _rows_in_order(vol, ms_dev, item_order)
    assert slab_module.overflows(dev) - before == n_bad * int(
        np.prod(shape))
    assert torch.equal(got, affine_resample(vol, ms_dev, 1))
    before = slab_module.overflows(dev)
    assert torch.equal(affine_slab(vol, ms_dev, 1, plan=plan), got)
    assert slab_module.overflows(dev) - before == n_bad * int(
        np.prod(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["scale_40", "nan_in_row_0"])
def test_boxes_over_tma_on_the_card(dev, case):
    """The CPU case on the card: the row path serves the launch, bit for
    bit the walk kernel that served it before the row rule."""
    from voltools_tpu_torch.kernels.affine_resample import affine_resample
    from voltools_tpu_torch.kernels.layout import pitched
    from voltools_tpu_torch.volume import StaticVolume
    shape = (300, 300, 12)
    ms = _over_tma(case, shape)
    vol = np.random.default_rng(5).random(shape).astype(np.float32)
    before = affine_slab.row_launches
    got = StaticVolume(vol, "linear", device="cuda").affine_batch(
        ms, output="device")
    assert tvt.last_dispatch()["rule"] == "rows"
    assert affine_slab.row_launches - before == 1
    want = affine_resample(pitched(torch.from_numpy(vol).to(dev)),
                           torch.from_numpy(ms).to(dev), 1)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["constant", "border"])
def test_non_finite_voxels_stay_off_their_x_neighbour(dev, mode):
    """Where the two paths part: an Inf or NaN voxel makes the general
    kernel's voxel at x - 1 NaN (its x lerp's weight 0 times it), not the
    row path's; every other voxel is bit for bit the same."""
    from voltools_tpu_torch.kernels.layout import pitched
    shape = (37, 50, 61)
    ms = cell_tilt_series(ANGLES, shape)[18:24]
    vol = torch.rand(shape, device=dev)
    vol[18, 20, 30] = float("nan")
    vol[10, 31, 40] = float("inf")
    vol[25, 12, 1] = float("-inf")
    vol = pitched(vol)
    plan = route(ms, shape, "linear", mode).plan
    ms_dev = torch.from_numpy(ms).to(dev)
    got = affine_slab(vol, ms_dev, 1, mode, plan=plan)
    want = affine_slab(vol, ms_dev, 1, mode, plan=plan, _force_general=True)
    parted = ~torch.isfinite(want) & torch.isfinite(got)
    assert int(parted.sum()) > 0
    # only the general kernel's NaN from the x lerp parts them
    assert torch.isnan(want[parted]).all()
    same = ~parted
    assert torch.equal(torch.nan_to_num(got[same]),
                       torch.nan_to_num(want[same]))
    assert torch.equal(torch.isnan(got[same]), torch.isnan(want[same]))


@pytest.mark.cuda
def test_row_launches_are_counted(dev):
    """The projector's sweeps: tilts at position 0 launch the row path,
    random rotations in one launch leave its counter as it was."""
    from voltools_tpu_torch.volume import StaticVolume
    shape = (40, 48, 56)
    vol = np.random.default_rng(4).random(shape).astype(np.float32)
    tp = TiltSeriesProjector(vol, "linear", device="cuda")
    before = affine_slab.row_launches
    tp.project(ANGLES, tilt_axis=0, output="device")
    chunks = -(-len(ANGLES) // StaticVolume.batch_chunk(shape))
    assert affine_slab.row_launches - before == chunks
    sv = StaticVolume(vol, "linear", device="cuda")
    before = affine_slab.row_launches
    sv.affine_batch(_random_rotations(shape), output="device")
    tp.project(ANGLES, tilt_axis=1, output="device")
    assert affine_slab.row_launches == before
