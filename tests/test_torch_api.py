"""The PyTorch port's public API, as a whole, against the JAX package's.

The port's ``StaticVolume(device='cpu')`` and one-shot functions (the plain
torch path) are held against the JAX package on ``device='jax'`` (its XLA
sampler on the CPU) on the same seeded inputs, at atol 5e-5 off knife
edges.  The output contract, the state carried over by
``voltools_tpu_torch.convert`` and the import isolation (no JAX, nothing of
``voltools_tpu``) are checked too."""

import pytest

torch = pytest.importorskip("torch")

import ast
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np

import voltools_tpu as jvt
import voltools_tpu_torch as tvt
from voltools_tpu.utils import transform_matrix
from voltools_tpu_torch.convert import from_state
from voltools_tpu_torch.kernels.affine_resample import affine_resample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (17, 19, 23)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def assert_close_off_edges(got, want, m, atol=5e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.where(knife_edge_mask(m, got.shape), 0.0, np.abs(got - want))
    assert err.max() <= atol, f"max err {err.max():.2e} off knife edges"


def rotations(n, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return np.stack([
        transform_matrix(rotation=tuple(rng.uniform(-180, 180, 3)),
                         rotation_order="sxyz",
                         center=tuple(s / 2 for s in shape))
        for _ in range(n)]).astype(np.float32)


@pytest.fixture(scope="module")
def vol():
    return np.random.default_rng(21).random(SHAPE).astype(np.float32)


@pytest.mark.parametrize("interpolation,mode,cval", [
    ("linear", "constant", 0.0),
    ("filt_bspline", "constant", 1.5),
    ("bspline", "border", 0.0),
])
def test_static_volume_matches_jax(vol, interpolation, mode, cval):
    jsv = jvt.StaticVolume(vol, interpolation, device="jax", mode=mode,
                           cval=cval)
    tsv = tvt.StaticVolume(vol, interpolation, device="cpu", mode=mode,
                           cval=cval)
    ms = rotations(3, seed=1)
    for m in ms[:2]:
        assert_close_off_edges(tsv.affine(m), jsv.affine(m), m)
    batch = tsv.affine_batch(ms)
    want = jsv.affine_batch(ms)
    assert batch.shape == (3,) + SHAPE
    for i, m in enumerate(ms):
        assert_close_off_edges(batch[i], want[i], m)
    m_rot = transform_matrix(rotation=(25, -10, 40), rotation_order="rzxz")
    assert_close_off_edges(tsv.rotate((25, -10, 40)),
                           jsv.rotate((25, -10, 40)), m_rot)
    m_tr = transform_matrix(translation=(1.3, -0.6, 2.2))
    assert_close_off_edges(tsv.translate((1.3, -0.6, 2.2)),
                           jsv.translate((1.3, -0.6, 2.2)), m_tr)
    kw = dict(scale=1.1, shear=(0.05, 0, 0.1), rotation=(10, 20, 30))
    m_t = transform_matrix(scale=(1.1,) * 3, shear=(0.05, 0, 0.1),
                           rotation=(10, 20, 30),
                           center=np.divide(np.subtract(SHAPE, 1), 2))
    assert_close_off_edges(tsv.transform(**kw), jsv.transform(**kw), m_t)


@pytest.mark.parametrize("interpolation", tvt.AVAILABLE_INTERPOLATIONS)
def test_one_shot_affine_matches_jax(vol, interpolation):
    m = rotations(1, seed=3)[0]
    assert_close_off_edges(
        tvt.affine(vol, m, interpolation, device="cpu"),
        jvt.affine(vol, m, interpolation, device="jax"), m)


def test_one_shot_functions_and_reshape_match_jax(vol):
    cases = [
        ("rotate", dict(rotation=(30, 10, -5)), transform_matrix(
            rotation=(30, 10, -5))),
        ("translate", dict(translation=(0.4, 1.7, -2.2)),
         transform_matrix(translation=(0.4, 1.7, -2.2))),
        ("scale", dict(coefficients=0.87), transform_matrix(scale=(0.87,) * 3)),
        ("shear", dict(coefficients=(0.1, 0.2, -0.15)),
         transform_matrix(shear=(0.1, 0.2, -0.15))),
    ]
    for name, kw, m in cases:
        got = getattr(tvt, name)(vol, device="cpu", mode="border", **kw)
        want = getattr(jvt, name)(vol, device="jax", mode="border", **kw)
        assert_close_off_edges(got, want, m)
    kw = dict(rotation=(40, 0, 0), rotation_order="rzxz", scale=1.2)
    assert_close_off_edges(tvt.transform(vol, device="cpu", **kw),
                           jvt.transform(vol, device="jax", **kw),
                           transform_matrix(rotation=(40, 0, 0),
                                            scale=(1.2,) * 3,
                                            center=np.divide(
                                                np.subtract(SHAPE, 1), 2)))
    m = rotations(1, seed=4)[0]
    got = tvt.affine(vol, m, reshape=True, device="cpu")
    want = jvt.affine(vol, m, reshape=True, device="jax")
    assert got.shape == want.shape and got.shape != SHAPE
    pad, _, _ = tvt.utils.compute_post_transform_dimensions(SHAPE, m)
    assert_close_off_edges(got, want, m @ tvt.utils.translation_matrix(pad))


def test_convert_carries_jax_state(vol):
    ms = rotations(2, seed=5)
    for interpolation in ("linear", "filt_bspline"):
        jsv = jvt.StaticVolume(vol, interpolation, device="jax",
                               mode="constant", cval=0.25)
        tsv = from_state(np.asarray(jsv.data), jsv.interpolation, jsv.mode,
                         jsv.cval, jsv.shape, device="cpu")
        # the coefficients are carried over as they are, not filtered again
        np.testing.assert_array_equal(tsv.data.numpy(), np.asarray(jsv.data))
        for m in ms:
            assert_close_off_edges(tsv.affine(m), jsv.affine(m), m)
    with pytest.raises(ValueError):
        from_state(vol, "linear", shape=(1, 2, 3), device="cpu")


def test_static_volume_on_cpu_keeps_a_private_copy(vol):
    data = vol.copy()
    sv = tvt.StaticVolume(data, "linear", device="cpu")
    before = sv.affine(np.eye(4))
    data[:] = 0
    np.testing.assert_array_equal(sv.affine(np.eye(4)), before)
    np.testing.assert_array_equal(before, vol)


def test_output_contract(vol):
    m = rotations(1, seed=6)[0]
    want = tvt.affine(vol, m, device="cpu")
    assert isinstance(want, np.ndarray) and want.dtype == np.float32
    buf = np.zeros(SHAPE, np.float32)
    assert tvt.affine(vol, m, device="cpu", output=buf) is None
    np.testing.assert_array_equal(buf, want)
    buf64 = np.zeros(SHAPE, np.float64)
    assert tvt.affine(vol, m, device="cpu", output=buf64) is None
    np.testing.assert_array_equal(buf64, want)
    with pytest.raises(ValueError):
        tvt.affine(vol, m, device="cpu", output=np.zeros((1,) + SHAPE,
                                                         np.float32))
    with pytest.raises(ValueError):
        tvt.affine(vol, m, device="cpu", output=np.zeros(SHAPE, np.int32))
    with pytest.raises(ValueError):
        tvt.affine(vol, m, device="cpu", output="Device")
    with pytest.raises(ValueError):
        tvt.affine(vol, m, device="cpu", output="device")
    with pytest.raises(ValueError):
        tvt.affine(vol[0], m, device="cpu")
    with pytest.raises(ValueError):
        tvt.affine(vol, m, "cubic", device="cpu")
    with pytest.raises(ValueError):
        tvt.affine(vol, m, device="cpu", mode="wrap")
    with pytest.raises(ValueError):
        tvt.affine(vol, m, device="tpu")
    np.testing.assert_array_equal(vol, np.random.default_rng(21).random(
        SHAPE).astype(np.float32)), "inputs are never mutated"


def test_cuda_is_the_default_and_raises_without_it(vol):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = np.eye(4)
    with pytest.raises(ValueError, match="Unknown device"):
        tvt.affine(vol, m)
    with pytest.raises(ValueError, match="Unknown device"):
        tvt.affine(vol, m, output="device")
    with pytest.raises(ValueError, match="Unknown device"):
        tvt.StaticVolume(vol)
    with pytest.raises(ValueError):
        tvt.StaticVolume(vol, device="cuda:0")


def test_static_volume_output_contract(vol):
    sv = tvt.StaticVolume(vol, "filt_bspline", device="cpu", autotune=3)
    m = rotations(1, seed=7)[0]
    want = sv.affine(m)
    out = torch.full(SHAPE, -1.0)
    before = affine_resample.launches
    assert sv.affine(m, output=out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    assert affine_resample.launches == before
    with pytest.raises(ValueError):
        sv.affine(m, output=torch.empty((2, 2, 2)))
    with pytest.raises(ValueError):
        sv.affine(m, output=torch.empty(SHAPE, dtype=torch.float64))
    with pytest.raises(ValueError):
        sv.affine(m, output="device")
    with pytest.raises(ValueError):
        sv.affine(m, output=np.zeros((3, 3, 3), np.float32))
    buf = np.zeros(SHAPE, np.float32)
    assert sv.affine(m, output=buf) is None
    np.testing.assert_array_equal(buf, want)

    ms = rotations(2, seed=8)
    stack = np.zeros((2,) + SHAPE, np.float32)
    assert sv.affine_batch(ms, output=stack) is None
    np.testing.assert_array_equal(stack[1], sv.affine(ms[1]))
    with pytest.raises(ValueError):
        sv.affine_batch(ms, output=np.zeros(SHAPE, np.float32))
    with pytest.raises(ValueError):
        sv.affine_batch(ms[0])
    empty = sv.affine_batch(np.zeros((0, 4, 4)))
    assert empty.shape == (0,) + SHAPE and empty.dtype == np.float32
    assert sv.affine_batch([]).shape == (0,) + SHAPE
    assert sv.affine_batch(np.zeros((0, 4, 4)),
                           output=np.zeros((0,) + SHAPE, np.float32)) is None
    with pytest.raises(ValueError):
        tvt.StaticVolume(vol, "linear", device="cpu",
                         prefilter_boundary="wrap")


def test_affine_batch_chunks_under_the_output_budget(vol, monkeypatch):
    sv = tvt.StaticVolume(vol, "linear", device="cpu")
    ms = rotations(5, seed=9)
    want = sv.affine_batch(ms)
    # two volumes per launch: 5 matrices take 3 launches' worth of chunks
    monkeypatch.setattr(tvt.StaticVolume, "_BATCH_BYTES_BUDGET",
                        2 * 4 * int(np.prod(SHAPE)))
    calls = []
    real = sv._resample
    monkeypatch.setattr(sv, "_resample",
                        lambda mats, out=None: calls.append(len(mats))
                        or real(mats, out))
    np.testing.assert_array_equal(sv.affine_batch(ms), want)
    assert calls == [2, 2, 1]


def test_prefilter_boundary_clamp_matches_jax(vol):
    m = rotations(1, seed=10)[0]
    jsv = jvt.StaticVolume(vol, "filt_bspline", device="jax",
                           prefilter_boundary="clamp")
    tsv = tvt.StaticVolume(vol, "filt_bspline", device="cpu",
                           prefilter_boundary="clamp")
    assert_close_off_edges(tsv.affine(m), jsv.affine(m), m)


def test_dispatch_profile_and_fallback_warning(vol, capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("error", tvt.PerformanceFallbackWarning)
        tvt.affine(vol, rotations(1)[0], device="cpu", profile=True)
    assert "transform finished in" in capsys.readouterr().out
    assert tvt.last_dispatch()["impl"] == "torch"
    assert issubclass(tvt.PerformanceFallbackWarning, RuntimeWarning)
    assert tvt.AVAILABLE_DEVICES[0] == "cpu"
    for name in ("affine", "transform", "translate", "shear", "scale",
                 "rotate", "StaticVolume", "last_dispatch",
                 "PerformanceFallbackWarning", "AVAILABLE_INTERPOLATIONS",
                 "utils", "ops"):
        assert hasattr(tvt, name), name


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import voltools_tpu_torch, voltools_tpu_torch.convert\n"
        "import voltools_tpu_torch.kernels.affine_resample\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m.startswith('jaxlib.')\n"
        "       or m == 'voltools_tpu' or m.startswith('voltools_tpu.')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_modules(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_sources_and_chip_smoke_name_no_jax():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "voltools_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "voltools_tpu"), (path, name)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # alone in a directory, without the package, it fails too
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
