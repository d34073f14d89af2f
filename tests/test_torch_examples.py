"""The port's examples (``examples/torch_*.py``) against the JAX package.

Each example's ``main`` runs on ``device='cpu'`` (the port's plain torch
versions) at a small size, and the JAX package's own calls run on the
same arrays on ``device='jax'`` (the reference sampler on the CPU).
Tolerances, and why:

* transformation, atol 5e-5 off knife edges (``tests/test_walk.py``'s
  standard); its scipy column equals the JAX package's ``device='cpu'``
  (both are ``scipy.ndimage.affine_transform`` of one matrix);
* projections, atol 1e-4: each sums 24 voxels that agree to a few float32
  roundings, in another order;
* WBP and SIRT, 1e-4 of the largest value (the FFTs, gathers and sums run
  in another order);
* the phase-correlation shift, atol 1e-6: the refined peak lands on the
  same grid point; the recovered transform within
  ``tests/test_registration.py``'s bounds, 0.3 degrees and 0.05 voxel.

The examples import no JAX and nothing of ``voltools_tpu``, and without a
card their default device raises."""

import ast
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import voltools_tpu as jvt
import voltools_tpu.models as jm
from voltools_tpu.ops.sampling import affine_sample as jax_affine_sample

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("transformation", "projections", "reconstruction", "registration")
KNIFE_ATOL = 5e-5
PROJ_ATOL = 1e-4
RECON_RTOL = 1e-4
PCC_ATOL = 1e-6
REG_DEG_TOL = 0.3
REG_T_TOL = 0.05
# small sizes: the whole file runs on one core in well under 20 s
TRANSFORM_SIZE = 24
PROJ_SIZE = 24
RECON_SIZE = 32
RECON_ITERATIONS = 2
REG_SIZE = 32
REG_STEPS = 60
REG_LEVELS = 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process keeps parallel test workers
    from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load(name):
    """``examples/torch_<name>.py`` as a module (``examples/`` is not a
    package)."""
    path = EXAMPLES / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def knife_edge_mask(m, shape, tol=1e-4):
    """True where any source coordinate is within ``tol`` of an integer
    (an exactly integral matrix row has no knife edge)."""
    idx = np.indices(shape, dtype=np.float64).reshape(3, -1)
    mm = np.asarray(m, np.float64)
    src = mm[:3, :3] @ idx + mm[:3, 3:4]
    near = np.abs(src - np.round(src)) < tol
    for a in range(3):
        if (np.all(mm[a] == np.round(mm[a]))
                and np.count_nonzero(mm[a, :3]) <= 1):
            near[a] = False
    return near.any(axis=0).reshape(shape)


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_neither_jax_nor_the_jax_package(name):
    tree = ast.parse((EXAMPLES / f"torch_{name}.py").read_text())
    modules = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            modules.add(node.module or "")
    roots = {m.split(".")[0] for m in modules}
    assert "voltools_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "voltools_tpu"}, sorted(modules)


@pytest.mark.parametrize("name", NAMES)
def test_example_raises_on_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="No CUDA device"):
        load(name).main(device="cuda", figure=None)


def test_transformation_matches_jax():
    ex = load("transformation")
    transformation = ex.main("cpu", TRANSFORM_SIZE, figure=None)
    kwargs = dict(rotation=ex.ROTATION, rotation_order=ex.ROTATION_ORDER,
                  translation=ex.TRANSLATION, interpolation=ex.INTERPOLATION)
    volume = transformation["volume"]
    want = jvt.transform(volume, device="jax", **kwargs)
    got = transformation["device"]
    assert got.shape == volume.shape and got.dtype == np.float32
    err = np.where(knife_edge_mask(transformation["matrix"], got.shape), 0.0,
                   np.abs(got - want))
    assert err.max() <= KNIFE_ATOL, err.max()
    # the scipy column is the JAX package's device='cpu' path
    np.testing.assert_array_equal(
        transformation["scipy"], jvt.transform(volume, device="cpu",
                                               **kwargs))
    assert transformation["max_abs_diff"] == float(
        np.abs(transformation["scipy"] - got).max())


def test_projections_levels_match_jax():
    ex = load("projections")
    result = ex.main("cpu", PROJ_SIZE, figure=None)
    volume = result["volume"]
    proj = jm.TiltSeriesProjector(volume, device="jax",
                                  rotation_order=ex.ROTATION_ORDER)
    np.testing.assert_array_equal(
        result["matrices"], proj.tilt_matrices(ex.ANGLES, ex.TILT_AXIS))
    want = np.asarray(proj.project(ex.ANGLES, tilt_axis=ex.TILT_AXIS))
    assert want.shape == (len(ex.ANGLES), PROJ_SIZE, PROJ_SIZE)
    for level in ("one_shot", "static_volume", "projector"):
        np.testing.assert_allclose(result[level], want, atol=PROJ_ATOL,
                                   err_msg=level)
    assert max(result["max_abs_diff"].values()) <= PROJ_ATOL


def test_reconstruction_matches_jax():
    ex = load("reconstruction")
    result = ex.main("cpu", RECON_SIZE, iterations=RECON_ITERATIONS,
                     figure=None)
    vol = result["volume"]
    shape = vol.shape
    proj = jm.TiltSeriesProjector(vol, interpolation="linear", device="jax")
    ms = proj.tilt_matrices(ex.ANGLES, tilt_axis=ex.TILT_AXIS)
    np.testing.assert_array_equal(result["matrices"], ms)
    tilts = np.asarray(proj.project(ex.ANGLES, tilt_axis=ex.TILT_AXIS))
    np.testing.assert_allclose(result["projections"], tilts,
                               atol=RECON_RTOL * np.abs(tilts).max())
    # WBP and SIRT of the example's own projections
    for name, want in (
            ("wbp", jm.wbp_reconstruct(result["projections"], ms, shape,
                                       device="jax")),
            ("sirt", jm.sirt_reconstruct(result["projections"], ms, shape,
                                         iterations=RECON_ITERATIONS,
                                         device="jax"))):
        want = np.asarray(want)
        got = result[name]
        assert got.shape == shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want,
                                   atol=RECON_RTOL * np.abs(want).max(),
                                   err_msg=name)
        assert 0.5 < result["interior_correlation"][name] <= 1.0


def test_registration_matches_jax_and_recovers_the_transform():
    ex = load("registration")
    result = ex.main("cpu", REG_SIZE, steps=REG_STEPS, levels=REG_LEVELS,
                     figure=None)
    ref, moving = result["reference"], result["moving"]
    # the moving volume as the JAX example makes it (its reference sampler,
    # the same rescale and noise; the port's rodrigues_matrix is held to
    # the JAX one in tests/test_torch_matrices.py)
    want = np.asarray(jax_affine_sample(ref, result["m_true"], "linear"))
    noise = np.random.default_rng(1).normal(0, 0.01, want.shape)
    np.testing.assert_allclose(moving, (1.7 * want + 0.2 + noise).astype(
        np.float32), atol=1e-5)
    shift = np.asarray(jm.phase_cross_correlation(ref, moving,
                                                  upsample=ex.UPSAMPLE))
    np.testing.assert_allclose(result["phase_correlation_shift"], shift,
                               atol=PCC_ATOL)
    assert len(result["loss_history"]) == REG_STEPS * REG_LEVELS
    assert result["rotation_error_deg"] <= REG_DEG_TOL
    assert result["translation_error_vox"] <= REG_T_TOL
    np.testing.assert_allclose(result["w"], result["w_expect"],
                               atol=np.radians(REG_DEG_TOL))
    assert result["misfit"]["after"] < result["misfit"]["before"]


def test_figure_is_written_only_where_asked(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    figure = tmp_path / "figures" / "torch_transformation_example.png"
    figure.parent.mkdir()
    load("transformation").main("cpu", 12, figure=figure)
    assert figure.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert list(figure.parent.iterdir()) == [figure]
    assert list(cwd.iterdir()) == []
