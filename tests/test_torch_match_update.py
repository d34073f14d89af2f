"""Template matching's update kernel (``kernels/match_update.py``).

On the CPU: the plain version and the wrapper against the four torch
kernels the matcher ran before the kernel, bit for bit (the bit patterns
of the scores, so a NaN counts as equal to itself), over ties, NaN in the
correlation and in the best, infinities, ``inv`` of 0, the start after
``reset()`` and a run of orientations; and an emulation of the source's
thread -> voxel mapping, which a source check pins, taking every voxel
once in the committed layout and in each one that
``tools/match_update_variants.py`` builds.  The card tests (marker ``cuda``,
skipped without a CUDA device) hold the kernel to the plain version on the
card, bit for bit, over the same cases, lengths that are not a multiple of
4 and a tomogram-sized map; its improved-voxel counter to the indices it
changed; and ``TemplateMatcher.match`` to queueing without a synchronise.
They import no JAX; on the card's machine::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_match_update.py -q
"""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from voltools_tpu_torch import TemplateMatcher
from voltools_tpu_torch.kernels import match_update as mu

SHAPE = (5, 7, 9)          # 315 voxels: not a multiple of 4
RUN = 8                    # orientations of a run
CASES = ("ties", "nan_cc", "nan_best", "inf", "inv_zero", "reset_start",
         "subnormal")


def four_ops(cc, inv, scores, indices, index):
    """The matcher's update before the kernel, as it ran: the correlation
    scaled in place, the compare into a bool map, the maximum, the fill."""
    cc = cc.clone()
    better = torch.empty(cc.shape, dtype=torch.bool, device=cc.device)
    cc.mul_(inv)
    torch.gt(cc, scores, out=better)
    torch.maximum(scores, cc, out=scores)
    indices.masked_fill_(better, index)


def case(name, shape=SHAPE, seed=21):
    """(cc, inv, scores, indices, index) on the CPU for case ``name``."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    cc = rng.standard_normal(n).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, n).astype(np.float32)
    scores = rng.standard_normal(n).astype(np.float32)
    indices = rng.integers(-1, 50, n).astype(np.int32)
    pick = rng.random(n) < 0.3
    if name == "ties":
        scores[pick] = (cc * inv)[pick]
    elif name == "nan_cc":
        cc[pick] = np.nan
    elif name == "nan_best":
        scores[pick] = np.nan
    elif name == "inf":
        k = rng.integers(0, 5, n)
        cc[pick & (k == 0)] = np.inf
        cc[pick & (k == 1)] = -np.inf
        inv[pick & (k == 2)] = np.inf
        scores[pick & (k == 3)] = np.inf
        scores[pick & (k == 4)] = -np.inf
        cc[(k == 2) & ~pick] = 0.0       # 0 x inf: NaN
        inv[(k == 2) & ~pick] = np.inf
    elif name == "inv_zero":
        inv[pick] = 0.0
        zero = rng.random(n) < 0.5
        scores[zero] = np.where(rng.random(n) < 0.5, -0.0, 0.0)[zero]
    elif name == "reset_start":
        scores[:] = -np.inf
        indices[:] = -1
    elif name == "subnormal":
        cc *= np.float32(1e-20)
        inv *= np.float32(1e-20)
        scores = (scores * np.float32(1e-40)).astype(np.float32)
    else:
        raise ValueError(name)
    return (torch.from_numpy(cc).view(shape), torch.from_numpy(inv).view(shape),
            torch.from_numpy(scores).view(shape),
            torch.from_numpy(indices).view(shape), 7)


def run_inputs(shape=SHAPE, seed=22):
    """A run after ``reset()``: ``inv`` with zeros, correlations of both
    signs, one equal to an earlier one (ties), one with NaN."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    inv = rng.uniform(0.5, 2.0, n).astype(np.float32)
    inv[rng.random(n) < 0.1] = 0.0
    ccs = [rng.standard_normal(n).astype(np.float32) for _ in range(RUN)]
    ccs[3] = ccs[1].copy()
    ccs[5][rng.random(n) < 0.05] = np.nan
    return ([torch.from_numpy(c).view(shape) for c in ccs],
            torch.from_numpy(inv).view(shape))


def fresh(shape, device="cpu"):
    """The maps as ``reset()`` leaves them."""
    return (torch.full(shape, -math.inf, device=device),
            torch.full(shape, -1, dtype=torch.int32, device=device))


def assert_same(a, b):
    """Scores and indices equal bit for bit."""
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("update", ["plain", "wrapper"])
@pytest.mark.parametrize("name", CASES)
def test_the_plain_version_is_the_four_ops(name, update):
    cc, inv, scores, indices, index = case(name)
    want = (scores.clone(), indices.clone())
    four_ops(cc, inv, *want, index)
    got = (scores.clone(), indices.clone())
    kept = cc.clone()
    launches = mu.match_update.launches
    fn = mu.plain_match_update if update == "plain" else mu.match_update
    fn(cc, inv, *got, index)
    assert_same(got, want)
    assert torch.equal(cc.view(torch.int32), kept.view(torch.int32))
    assert mu.match_update.launches == launches


def test_the_plain_version_over_a_run_of_orientations():
    ccs, inv = run_inputs()
    want, got = fresh(SHAPE), fresh(SHAPE)
    for k, cc in enumerate(ccs):
        four_ops(cc, inv, *want, k)
        mu.match_update(cc, inv, *got, k)
        assert_same(got, want)
    # the run reached every kind of voxel: a NaN best, zero scores
    assert torch.isnan(got[0]).any() and (got[0] == 0).any()


@pytest.mark.parametrize("fault", ["dtype", "index_dtype", "shape",
                                   "contiguous", "empty", "index"])
def test_the_wrapper_refuses(fault):
    cc, inv, scores, indices, index = case("reset_start")
    if fault == "dtype":
        inv = inv.double()
    elif fault == "index_dtype":
        indices = indices.long()
    elif fault == "shape":
        scores = scores[:-1]
    elif fault == "contiguous":
        scores = scores.transpose(0, 2)
    elif fault == "empty":
        cc, inv, scores, indices = (t[:0] for t in (cc, inv, scores,
                                                    indices))
    else:
        index = 2 ** 31
    with pytest.raises(ValueError):
        mu.match_update(cc, inv, scores, indices, index)


# ------------------------------- the layouts: every voxel taken once

ROOT = Path(__file__).resolve().parent.parent
SOURCE = (ROOT / "voltools_tpu_torch" / "csrc" / "match_update.cu").read_text()


def _study():
    spec = importlib.util.spec_from_file_location(
        "match_update_variants", ROOT / "tools" / "match_update_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


STUDY = _study()


def taken(n, threads, groups):
    """The voxels a launch over ``n`` takes, one entry a take, by the
    source's mapping: CTA b's thread t takes float4 group
    b * threads * groups + k * threads + t for k < groups, those below
    n // 4; the first CTA's threads t < n % 4 take voxel 4 (n // 4) + t."""
    total = n >> 2
    per_block = threads * groups
    blocks = max(1, -(-total // per_block))
    b, t, k = np.meshgrid(np.arange(blocks), np.arange(threads),
                          np.arange(groups), indexing="ij")
    g = (b * per_block + k * threads + t).ravel()
    g = g[g < total]
    tail = 4 * total + np.arange(n & 3)
    return np.concatenate([(4 * g[:, None] + np.arange(4)).ravel(), tail])


def test_the_source_has_the_emulated_mapping():
    flat = re.sub(r"\s+", " ", SOURCE)
    for piece in ("static_cast<long long>(blockIdx.x) * kThreads * kGroups "
                  "+ threadIdx.x",
                  "first + static_cast<long long>(k) * kThreads",
                  "if (g < groups)",
                  "blockIdx.x == 0 && threadIdx.x < (n & 3)",
                  "const long long t = 4 * groups + threadIdx.x",
                  "((n >> 2) + per_block - 1) / per_block"):
        assert piece in flat, piece


@pytest.mark.parametrize("layout", STUDY.LAYOUTS)
def test_the_study_builds_each_layout_from_the_source(layout):
    text = STUDY.edited(SOURCE, *layout)
    threads, groups = layout
    assert f"constexpr int kThreads = {threads};" in text
    assert f"constexpr int kGroups = {groups};" in text
    if layout == STUDY.LAYOUTS[0]:
        assert text == SOURCE               # the committed layout


@pytest.mark.parametrize("layout", STUDY.LAYOUTS)
@pytest.mark.parametrize("n", [1, 3, 5, 4099, 4 * 2 * 2048 + 3])
def test_every_voxel_is_taken_once(layout, n):
    assert np.array_equal(np.sort(taken(n, *layout)), np.arange(n))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def on_card(dev, cc, inv, scores, indices, index):
    """The kernel's and the plain version's maps on the card, the
    kernel's improved-voxel count for one update and the voxels where
    ``cc * inv > scores``."""
    cc, inv = cc.to(dev), inv.to(dev)
    plain = (scores.to(dev), indices.to(dev))
    better = int(torch.gt(cc * inv, plain[0]).sum())
    mu.plain_match_update(cc, inv, *plain, index)
    kernel = (scores.to(dev), indices.to(dev))
    before = mu.improved_voxels(dev)
    mu.match_update(cc, inv, *kernel, index)
    torch.cuda.synchronize()
    return kernel, plain, mu.improved_voxels(dev) - before, better


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SHAPE, (1,), (2,), (3,), (5,), (4099,),
                                   (3, 4096 * 4 + 5)])
@pytest.mark.parametrize("name", CASES)
def test_on_the_card_the_kernel_is_the_plain_version(dev, name, shape):
    kernel, plain, improved, better = on_card(dev, *case(name, shape))
    assert_same(kernel, plain)
    assert improved == better


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SHAPE, (4099,), (256, 512, 512)])
def test_on_the_card_a_run_of_orientations(dev, shape):
    ccs, inv = run_inputs(shape)
    inv = inv.to(dev)
    plain, kernel = fresh(shape, dev), fresh(shape, dev)
    launches = mu.match_update.launches
    for k, cc in enumerate(ccs):
        cc = cc.to(dev)
        mu.plain_match_update(cc, inv, *plain, k)
        before_indices = kernel[1].clone()
        before = mu.improved_voxels(dev)
        mu.match_update(cc, inv, *kernel, k)
        assert_same(kernel, plain)
        # the count is the voxels whose index the launch replaced
        assert mu.improved_voxels(dev) - before == int(
            (kernel[1] != before_indices).sum())
    assert mu.match_update.launches - launches == RUN


@pytest.mark.cuda
def test_on_the_card_a_misaligned_map_is_refused(dev):
    cc, inv, scores, indices, index = case("reset_start", (64,))
    maps = [t.to(dev)[1:] for t in (cc, inv, scores, indices)]
    with pytest.raises(ValueError, match="16-byte"):
        mu.match_update(*maps, index)


@pytest.mark.cuda
def test_on_the_card_match_launches_the_kernel_without_a_sync(dev):
    rng = np.random.default_rng(5)
    tomogram = rng.standard_normal((24, 40, 36)).astype(np.float32)
    template = rng.standard_normal((12, 12, 12)).astype(np.float32)
    mask = np.ones((12, 12, 12), np.float32)
    ms = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    tm = TemplateMatcher(tomogram, template, mask, device="cuda")
    tm.match(ms[:1])                      # builds the kernels
    tm.reset()
    torch.cuda.synchronize()
    launches = mu.match_update.launches
    before = mu.improved_voxels(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm.match(ms)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert mu.match_update.launches - launches == len(ms)
    scores, indices = tm.result()
    # one orientation four times: the first scores every voxel, the ties
    # after it keep its index
    assert mu.improved_voxels(dev) - before == int(
        np.isfinite(scores).sum())
    assert set(np.unique(indices)) <= {-1, 0}
