"""The port's launch seam (``voltools_tpu_torch/kernels/_build.py``) on the
CPU: every wrapper's launchers against a fake library, the launch counts
and the device counters, what the tracer reads of them, and that no other
module reaches a library but through the seam."""

import ast
import contextlib
from pathlib import Path

import pytest
import torch

import voltools_tpu_torch  # noqa: F401 (declares every library)
from voltools_tpu_torch.kernels import (_build, affine_resample,
                                        affine_slab, backproject,
                                        match_sigma, match_update,
                                        match_zpass, partial_sample)
from voltools_tpu_torch.utils import trace

PACKAGE = Path(_build.__file__).resolve().parent.parent
STREAM = 0x5eed
CODE = 7
DEVICE = torch.device("cuda", 3)

# (module, launcher, the message of a failed call with CODE, the launch
# counts a call adds to, whether it passes the stream)
LAUNCHERS = {
    "A": (affine_resample, "_LAUNCH",
          "affine_resample launch failed: fake failure (7)",
          ("affine_resample",), True),
    "B": (affine_slab, "_LAUNCH",
          "affine_slab launch failed: fake failure (7)",
          ("affine_slab",), True),
    "B rows": (affine_slab, "_ROWS",
               "affine_slab launch failed: fake failure (7)",
               ("affine_slab", "affine_slab.rows"), True),
    "B occupancy": (affine_slab, "_OCCUPANCY",
                    "affine_slab occupancy query failed: fake failure",
                    (), False),
    "C": (backproject, "_LAUNCH",
          "backproject launch failed: fake failure (7)",
          ("backproject",), True),
    "MU": (match_update, "_LAUNCH",
           "match_update launch failed: fake failure (7)",
           ("match_update",), True),
    "MU noise": (match_update, "_NOISE_LAUNCH",
                 "match_noise_update launch failed: fake failure (7)",
                 ("match_noise_update",), True),
    "SZ": (match_zpass, "_LAUNCH",
           "match_zpass launch failed: fake failure (7)",
           ("match_zpass",), True),
    "SX": (match_sigma, "_LAUNCH",
           "match_sigma launch failed: fake failure (7)",
           ("match_sigma",), True),
    "SX finish": (match_sigma, "_FINISH",
                  "match_sigma_finish launch failed: fake failure (7)",
                  ("match_sigma_finish",), True),
    "D1 step": (partial_sample, "_SAMPLE",
                "partial_sample launch failed: fake failure (7)",
                ("partial_sample",), True),
    "D1 ring": (partial_sample, "_RING",
                "partial_sample_ring launch failed: fake failure (7)",
                ("partial_sample_ring",), True),
    "D2": (partial_sample, "_PROJECT",
           "partial_project launch failed: fake failure (7)",
           ("partial_project",), True),
    "D2 line": (partial_sample, "_PROJECT_LINE",
                "partial_project launch failed: fake failure (7)",
                ("partial_project", "partial_project.line"), True),
}
LAUNCH_KEYS = {"launches.affine_resample", "launches.affine_slab",
               "launches.affine_slab.rows", "launches.backproject",
               "launches.partial_sample", "launches.partial_sample_ring",
               "launches.partial_project", "launches.partial_project.line",
               "launches.match_update", "launches.match_noise_update",
               "launches.match_zpass", "launches.match_sigma",
               "launches.match_sigma_finish"}
DEVICE_COUNTERS = {"fast_path_voxels", "overflows", "window_misses",
                   "improved_voxels"}


class FakeLibrary:
    """A loaded library whose every entry records its arguments and
    returns ``code``."""

    def __init__(self, code):
        self.code, self.calls, self.current = code, [], []

    def __getattr__(self, entry):
        def fn(*args):
            self.calls.append((entry, args))
            return self.code
        return fn


class FakeStream:
    cuda_stream = STREAM


@pytest.fixture
def fake(monkeypatch):
    """Installs a fake library in a wrapper's declaration, the current
    stream and device fakes and the launch counts a copy; returns the
    installer."""
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(_build, "_LAUNCHES", dict(_build._LAUNCHES))

    def install(library, code):
        lib = FakeLibrary(code)

        @contextlib.contextmanager
        def current(device):
            lib.current.append(device)
            yield
        monkeypatch.setattr(torch.cuda, "device", current)
        monkeypatch.setattr(library, "_lib", lib)
        monkeypatch.setattr(library, "_errors", lambda c: b"fake failure",
                            raising=False)
        return lib
    return install


@pytest.mark.parametrize("name", LAUNCHERS)
def test_a_failed_launch_raises_the_wrappers_message(fake, name):
    module, attr, message, counts, stream = LAUNCHERS[name]
    lib = fake(module.LIBRARY, CODE)
    before = _build.launches()
    with pytest.raises(RuntimeError) as raised:
        getattr(module, attr)(DEVICE, 1, 2.5)
    assert str(raised.value) == message
    assert _build.launches() == before, "a failed launch counts nothing"
    (entry, args), = lib.calls
    assert entry in module.LIBRARY.entries
    assert args == ((1, 2.5, STREAM) if stream else (1, 2.5))
    assert lib.current == [DEVICE]


@pytest.mark.parametrize("name", LAUNCHERS)
def test_a_launch_counts_under_its_names_until_a_reset(fake, name):
    module, attr, _, counts, _ = LAUNCHERS[name]
    fake(module.LIBRARY, 0)
    before = _build.launches()
    getattr(module, attr)(DEVICE)
    getattr(module, attr)(DEVICE)
    after = _build.launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == dict.fromkeys(counts, 2)
    _build.reset_launches()
    assert set(_build.launches().values()) == {0}


def test_counts_hold_the_nine_launch_keys():
    found = {k for k in trace.counts() if k.startswith("launches.")}
    assert found == LAUNCH_KEYS


def test_the_export_holds_the_launches_and_the_device_counters():
    trace.start()
    trace.stop()
    counters = trace.export()["otherData"]["counters"]
    assert LAUNCH_KEYS | DEVICE_COUNTERS <= set(counters)
    # no device anchored: every device counter reads 0
    assert {counters[k] for k in DEVICE_COUNTERS} == {0}


def test_device_counters_are_read_and_reset_per_device(monkeypatch):
    slots = torch.zeros((128, 16), dtype=torch.int64)
    slots[:, 0] = 3
    monkeypatch.setattr(_build, "_COUNTERS", {
        ("affine_resample", "fast_path_voxels", 0): slots.view(-1),
        ("affine_slab", "overflows", 0): torch.tensor([5], dtype=torch.int32),
        ("affine_slab", "overflows", 1): torch.tensor([2], dtype=torch.int32),
    })
    A, B = affine_resample, affine_slab
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert A.fast_path_voxels(cuda[0]) == 3 * 128
    assert [B.overflows(d) for d in cuda] == [5, 2, 0]
    assert backproject.window_misses(cuda[0]) == 0
    # the tracer sums each counter over the devices it anchored
    monkeypatch.setattr(trace, "_ANCHORS", {0: [], 1: []})
    assert trace._device_counters() == {"fast_path_voxels": 384,
                                        "overflows": 7, "window_misses": 0,
                                        "improved_voxels": 0}
    A.reset_fast_path_voxels(cuda[0])
    B.LIBRARY.reset("overflows", cuda[1])
    B.LIBRARY.reset("overflows", cuda[2])      # never made: nothing to do
    assert (A.fast_path_voxels(cuda[0]), B.overflows(cuda[0]),
            B.overflows(cuda[1])) == (0, 5, 0)


def test_the_counters_live_on_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        affine_slab.overflows("cpu")


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def test_the_tracer_imports_no_kernel_module():
    for node in ast.walk(_tree(PACKAGE / "utils" / "trace.py")):
        if isinstance(node, ast.ImportFrom):
            assert "kernels" not in (node.module or "") and not any(
                "kernels" in a.name for a in node.names), ast.dump(node)
        elif isinstance(node, ast.Import):
            assert not any("kernels" in a.name for a in node.names)


@pytest.mark.parametrize("name", sorted(
    p.name for p in (PACKAGE / "kernels").glob("*.py")
    if p.name != "_build.py"))
def test_only_the_seam_reaches_a_library(name):
    """No module under kernels/ but _build.py loads a library, reads the
    stream's handle or names an error string, and none sets a launch
    counter on a function."""
    for node in ast.walk(_tree(PACKAGE / "kernels" / name)):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("CDLL", "cuda_stream"), node.attr
            assert not node.attr.endswith("_error_string"), node.attr
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "_error_string" not in node.value
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            assert not any(isinstance(t, ast.Attribute)
                           and t.attr.endswith("launches")
                           for t in targets), ast.dump(node)
