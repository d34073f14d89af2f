"""The walk kernel's design, as far as a host without a card reaches.

``csrc/affine_resample.cu`` gives each warp a compact patch of output
voxels, takes an interior fast path on a warp-uniform test, and may read a
cubic row's taps as aligned float4 loads.  None of it runs here, so:

* a numpy emulation of its thread -> voxel mapping (the formulas of the
  source, which a source check pins) writes every output voxel of every
  matrix exactly once, for ragged shapes, extents of 1, ``out_shape``
  other than the volume's and batches, for the committed patch and the
  candidates ``tools/walk_variants.py`` builds;
* a torch emulation of the interior predicate (hypothesis over coordinates
  near and at the edges, ``n - 1`` exactly, both modes and orders): where
  it holds, the fast path's indices base + k are the ones the mirror and
  the clip give, and its tap sum equals the plain version bit for bit;
* the float4 row's select network picks the taps, and no load reaches past
  a row's padded end;
* the source keeps the shared per-voxel arithmetic and no FMA contraction;
* the wrapper's ``vector_rows``, and an emulation of the share of the
  in-range voxels whose warp takes the fast path (the kernel counts them on
  the device; ``tests/test_torch_cuda.py`` holds its counts against
  ``warp_path_counts`` below).

The kernel itself is held against its plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

import re

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from voltools_tpu_torch.kernels import _build
from voltools_tpu_torch.kernels import affine_resample as kernel_module
from voltools_tpu_torch.kernels.affine_resample import (
    DEEP_PATCH, FLAT_PATCH, vector_rows)
from voltools_tpu_torch.kernels.planner import patch_rows, walk_patch
from voltools_tpu_torch.kernels.layout import padded_width, pitched
from voltools_tpu_torch.ops.interpolation import (_mirror_index,
                                                  cubic_bspline_weights,
                                                  sample)
from voltools_tpu_torch.ops.sampling import affine_coords
from voltools_tpu_torch.utils import transform_matrix, translation_matrix

TEXT = open(_build.CSRC_DIR / "affine_resample.cu").read()
HEADER = open(_build.CSRC_DIR / "resample_taps.cuh").read()


def constant(name):
    return int(re.search(rf"\b{name} = (\d+)[;,]", TEXT).group(1))


KERNEL_BRICK = tuple(constant(f"kBrick{a}") for a in "ZYX")
KERNEL_VOXELS = dict(zip((1, 3), map(int, re.search(
    r"static constexpr int kVoxels = ORDER == 1 \? (\d+) : (\d+);",
    TEXT).groups())))
KERNEL_FLAT = tuple(constant(f"kFlat{a}") for a in "ZYX")
KERNEL_DEEP = tuple(constant(f"kDeep{a}") for a in "ZYX")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------- thread -> voxel mapping

def grid_of(out_shape, brick, voxels):
    """(bricks_x, bricks_y, bricks_z) of a launch, as the C entry computes
    them: a CTA covers ``voxels`` bricks stacked along z."""
    cta = (brick[0] * voxels,) + tuple(brick[1:])
    return tuple(-(-o // b) for o, b in zip(out_shape[::-1], cta[::-1]))


def fast_div(d):
    """The C entry's FastDiv of divisor d: (magic, shift)."""
    s = 0
    while (1 << s) < d:
        s += 1
    return ((1 << 32) * ((1 << s) - d)) // d + 1, s


def div(a, d):
    """FastDiv::div: (umulhi(a, magic) + a) >> shift, in 32 bits."""
    magic, s = fast_div(d)
    a = np.asarray(a, np.uint64)
    return (((a * np.uint64(magic)) >> np.uint64(32)) + a) >> np.uint64(s)


def thread_voxels(blocks, out_shape, patch, brick, voxels):
    """(z, y, x, here) of every voxel of every thread of the CTAs
    ``blocks`` (blockIdx.x), each (len(blocks), threads, voxels), as the
    kernel computes them for warps of ``patch`` in bricks of ``brick``."""
    pz, py, px = patch
    wy, wx = brick[1] // py, brick[2] // px
    o0, o1, o2 = out_shape
    bricks_x, bricks_y, _ = grid_of(out_shape, brick, voxels)
    t = np.arange(int(np.prod(brick)))
    lane, warp = t % 32, t // 32
    block = np.asarray(blocks, np.int64)[:, None]
    rest = div(block, bricks_x).astype(np.int64)
    bx = block - rest * bricks_x
    bz = div(rest, bricks_y).astype(np.int64)
    by = rest - bz * bricks_y
    x = bx * brick[2] + warp % wx * px + lane % px
    y = by * brick[1] + warp // wx % wy * py + lane // px % py
    z0 = bz * (brick[0] * voxels) + warp // (wx * wy) * pz + lane // (px * py)
    z = z0[..., None] + brick[0] * np.arange(voxels)
    x, y = (np.broadcast_to(a[..., None], z.shape) for a in (x, y))
    return z, y, x, (z < o0) & (y < o1) & (x < o2)


def test_mapping_matches_the_kernel_source():
    flat = re.sub(r"\s+", " ", TEXT)
    for line in (
            "const int lane = threadIdx.x % 32;",
            "const int warp = threadIdx.x / 32;",
            "const int rest = bricks_x.div(blockIdx.x);",
            "const int bx = blockIdx.x - rest * static_cast<int>(bricks_x.d);",
            "const int bz = bricks_y.div(rest);",
            "const int by = rest - bz * static_cast<int>(bricks_y.d);",
            "static constexpr int kWarpsY = kBrickY / PY;",
            "static constexpr int kWarpsX = kBrickX / PX;",
            "*x = bx * kBrickX + warp % kWarpsX * PX + lane % PX;",
            "*y = by * kBrickY + warp / kWarpsX % kWarpsY * PY + lane / PX "
            "% PY;",
            "*z = bz * (kBrickZ * voxels) + warp / (kWarpsX * kWarpsY) * "
            "PZ + lane / (PX * PY);",
            "constexpr int kVoxels = Tile<ORDER>::kVoxels;",
            "P::voxel(lane, warp, bz, by, bx, kVoxels, &z0, &y, &x);",
            "for (int v = 0; v < kVoxels; ++v) { const int z = z0 + v * "
            "kBrickZ; const bool here = z < o0 && y < o1 && x < o2;",
            "constexpr int kThreads = kBrickZ * kBrickY * kBrickX;",
            "using Flat = Patch<kFlatZ, kFlatY, kFlatX>;",
            "using Deep = Patch<kDeepZ, kDeepY, kDeepX>;",
            "dispatch<ORDER, CONSTANT, Deep>(a, vec, offsets32);",
            "const int bricks_x = (o2 + kBrickX - 1) / kBrickX;",
            "const int bricks_y = (o1 + kBrickY - 1) / kBrickY;",
            "const int stack = kBrickZ * (order == 1 ? Tile<1>::kVoxels : "
            "Tile<3>::kVoxels);",
            "const int bricks_z = (o0 + stack - 1) / stack;",
            "static_cast<long long>(bricks_x) * bricks_y * bricks_z;",
            "fast_div(bricks_x), fast_div(bricks_y), cval, counts};",
            "return static_cast<int>((__umulhi(u, magic) + u) >> shift);",
            "((1ull << 32) * ((1ull << s) - d)) / d + 1;",
            "out[((b * o0 + z) * o1 + y) * static_cast<long long>(o2) + x] "
            "= value;"):
        assert line in flat, line
    assert (KERNEL_FLAT, KERNEL_DEEP) == (FLAT_PATCH, DEEP_PATCH)
    for patch in (KERNEL_FLAT, KERNEL_DEEP):
        # a warp's stores are whole 32-byte sectors along x
        assert np.prod(patch) == 32 and patch[2] % 8 == 0
        assert all(b % p == 0 for b, p in zip(KERNEL_BRICK, patch))


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 16, 32, 63, 125, 1000,
                               65535, 2 ** 20 + 7, 2 ** 31 - 1])
def test_fast_division_of_cta_indices(d):
    rng = np.random.default_rng(d)
    near = np.array([k * d + r for k in (0, 1, 2, 3, 1000, 2 ** 31 // d)
                     for r in (-1, 0, 1, d - 1)])
    a = np.concatenate([np.arange(min(3 * d + 3, 5000)), near,
                        [2 ** 31 - 1, 2 ** 31 - 2],
                        rng.integers(0, 2 ** 31, 5000)])
    a = a[(a >= 0) & (a < 2 ** 31)]
    magic, _ = fast_div(d)
    assert 0 < magic < 2 ** 32
    assert np.array_equal(div(a, d), a // d)


def test_planner_picks_the_patch_with_fewer_rows():
    """walk_patch: the deep patch where its images span fewer source rows
    over the launch's matrices, the flat one on a tie."""
    eye = np.eye(4)
    assert patch_rows(eye, FLAT_PATCH) == patch_rows(eye, DEEP_PATCH) == 4.0
    assert walk_patch(eye) == FLAT_PATCH
    # a tilt about the output's z keeps a flat patch in one source plane;
    # a rotation that mixes all three axes takes the deep patch
    tilt = transform_matrix(rotation=(0, 40, 0), rotation_order="rzxz")
    assert walk_patch(tilt) == FLAT_PATCH
    mixed = transform_matrix(rotation=(40, 50, 60), rotation_order="sxyz")
    assert walk_patch(mixed) == DEEP_PATCH
    # a launch of several matrices sums their rows
    both = np.stack([tilt, mixed])
    assert walk_patch(both) == (
        DEEP_PATCH if patch_rows(both, DEEP_PATCH)
        < patch_rows(both, FLAT_PATCH) else FLAT_PATCH)
    assert walk_patch(np.full((4, 4), np.nan)) == FLAT_PATCH


def assert_written_once(out_shape, n, patch, brick, voxels):
    """Every voxel of the (n, *out_shape) output is written by exactly one
    thread, and no thread outside the output writes."""
    o0, o1, o2 = out_shape
    bricks_x, bricks_y, bricks_z = grid_of(out_shape, brick, voxels)
    per_layer = bricks_x * bricks_y
    counts = np.zeros(n * o0 * o1 * o2, np.uint8)
    for b in range(n):                      # blockIdx.y
        for layer in range(bricks_z):       # one z-layer of CTAs at a time
            blocks = np.arange(layer * per_layer, (layer + 1) * per_layer)
            z, y, x, here = thread_voxels(blocks, out_shape, patch, brick,
                                          voxels)
            flat = ((b * o0 + z[here]) * o1 + y[here]) * o2 + x[here]
            lo, hi = flat.min(), flat.max() + 1
            counts[lo:hi] += np.bincount(flat - lo, minlength=hi - lo).astype(
                np.uint8)
    assert counts.min() == 1 and counts.max() == 1


# the committed layouts and those tools/walk_variants.py builds
CANDIDATES = [(KERNEL_FLAT, KERNEL_BRICK, KERNEL_VOXELS[1]),
              (KERNEL_DEEP, KERNEL_BRICK, KERNEL_VOXELS[1]),
              (KERNEL_FLAT, KERNEL_BRICK, KERNEL_VOXELS[3]),
              (KERNEL_DEEP, KERNEL_BRICK, KERNEL_VOXELS[3]),
              ((1, 1, 32), (1, 1, 128), 1), ((1, 4, 8), (2, 4, 8), 2),
              ((2, 2, 8), (2, 4, 8), 2), ((1, 4, 8), (2, 8, 16), 1),
              ((2, 2, 8), (2, 8, 16), 3), ((1, 2, 16), (2, 8, 16), 2)]


@pytest.mark.parametrize("patch,brick,voxels", CANDIDATES)
@pytest.mark.parametrize("out_shape,n", [
    ((40, 48, 56), 1), ((1, 64, 80), 1), ((37, 1, 29), 2), ((5, 6, 1), 1),
    ((9, 17, 40), 5), ((3, 4, 250), 3), ((1, 1, 1), 2)])
def test_every_voxel_is_written_once(out_shape, n, patch, brick, voxels):
    assert_written_once(out_shape, n, patch, brick, voxels)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("patch", [KERNEL_FLAT, KERNEL_DEEP])
def test_every_voxel_of_250_cubed_is_written_once(patch, order):
    assert_written_once((250, 250, 250), 1, patch, KERNEL_BRICK,
                        KERNEL_VOXELS[order])


def test_warps_past_the_output_are_whole_or_masked():
    """A CTA of a ragged brick runs every lane to the warp vote: only the
    store is masked, so no lane leaves before __all_sync."""
    body = TEXT[TEXT.index("affine_resample_kernel("):]
    body = body[:body.index("struct Launch")]
    before_vote = body[:body.index("__all_sync")]
    assert "return" not in before_vote
    assert "if (here) {" in body


# ------------------------------------------------ the interior predicate

def plain_index(i, n, order, mode):
    """The index the edge path reads for tap index ``i`` (mirror for
    'constant' cubic, clip otherwise)."""
    if order == 3 and mode == "constant":
        return int(_mirror_index(torch.tensor(i), n))
    return min(max(i, 0), n - 1)


def weights_and_bases(s, order):
    """make_weights: per axis the first tap's index and the weights, in
    float32, as the kernel computes them."""
    first = 0 if order == 1 else -1
    bases, weights = [], []
    for a in range(3):
        f0 = torch.floor(s[a])
        f = s[a] - f0
        bases.append(int(f0) + first)
        weights.append([1.0 - f, f] if order == 1 else
                       list(cubic_bspline_weights(f)))
    return bases, weights


def interior(bases, shape, order):
    taps = 2 if order == 1 else 4
    return all(b >= 0 and b + taps <= n for b, n in zip(bases, shape))


def interior_sum(vol, bases, weights, order):
    """The fast path's tap sum: rows base + k, tap_sum's order."""
    taps = 2 if order == 1 else 4
    acc = torch.zeros((), dtype=torch.float32)
    for iz in range(taps):
        for iy in range(taps):
            w_zy = weights[0][iz] * weights[1][iy]
            for ix in range(taps):
                v = vol[bases[0] + iz, bases[1] + iy, bases[2] + ix]
                acc = acc + w_zy * weights[2][ix] * v
    return acc


def near_edge(n):
    """A float32 coordinate at, just off or a fraction off an integer near
    either end of an axis of n voxels."""
    ints = st.sampled_from([-1, 0, 1, 2, n - 4, n - 3, n - 2, n - 1, n])
    offsets = st.sampled_from([0.0, 1e-6, -1e-6, 0.25, -0.25, 0.5, -0.5,
                               0.9999, -0.9999])

    def point(k_off):
        k, off = k_off
        v = np.float32(k + off)
        if off == 1e-6:
            v = np.nextafter(np.float32(k), np.float32(np.inf))
        elif off == -1e-6:
            v = np.nextafter(np.float32(k), np.float32(-np.inf))
        return float(v)
    return st.tuples(ints, offsets).map(point)


@settings(max_examples=300, deadline=None)
@given(data=st.data(), shape=st.tuples(*[st.integers(1, 9)] * 3),
       order=st.sampled_from([1, 3]),
       mode=st.sampled_from(["constant", "border"]))
def test_interior_points_read_the_edge_paths_taps(data, shape, order, mode):
    s = torch.tensor([data.draw(near_edge(n)) for n in shape],
                     dtype=torch.float32)
    bases, weights = weights_and_bases(s, order)
    if not interior(bases, shape, order):
        return
    taps = 2 if order == 1 else 4
    for a in range(3):
        for k in range(taps):
            i = bases[a] + k
            assert 0 <= i < shape[a]            # 'border': every flag set
            assert plain_index(i, shape[a], order, mode) == i
    vol = torch.from_numpy(np.random.default_rng(sum(shape)).random(
        shape).astype(np.float32))
    want = sample(vol, s.view(3, 1), "linear" if order == 1 else "bspline",
                  mode, -3.0)[0]
    assert torch.equal(interior_sum(vol, bases, weights, order), want)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 9])
def test_knife_edges_take_the_edge_path(order, n):
    """A coordinate at exactly n - 1 (linear's clipped +1 tap, cubic's
    mirror row) or 0 (cubic's -1 tap) is never interior; the interior is
    [0, n - 1) for linear and [1, n - 2) for cubic."""
    for v in (0.0, n - 1.0, -0.25, n - 0.75):
        s = torch.tensor([v, v, v], dtype=torch.float32)
        bases, _ = weights_and_bases(s, order)
        inner = (0 <= v < n - 1) if order == 1 else (1 <= v < n - 2)
        assert interior(bases, (n,) * 3, order) == inner, v
    for v in np.linspace(-1.5, n + 0.5, 37, dtype=np.float32):
        s = torch.tensor([v] * 3)
        bases, _ = weights_and_bases(s, order)
        lo, hi = (0, n - 1) if order == 1 else (1, n - 2)
        assert interior(bases, (n,) * 3, order) == (lo <= v < hi), v


def test_interior_predicate_matches_the_header():
    flat = re.sub(r"\s+", " ", HEADER)
    assert ("return t.base[0] >= 0 && t.base[0] + kTaps <= n[0] && "
            "t.base[1] >= 0 && t.base[1] + kTaps <= n[1] && t.base[2] >= 0 "
            "&& t.base[2] + kTaps <= n[2];") in flat
    # make_taps takes its bases and weights from make_weights, so both
    # paths floor alike
    assert "make_weights<ORDER>(s, &wt);" in HEADER
    assert "t->base[a] = static_cast<int>(f0) + kFirst;" in HEADER
    flat_text = re.sub(r"\s+", " ", TEXT)
    # cubic alone takes the fast path, on a warp vote
    assert ("const bool fast = ORDER == 3 && __all_sync(kWarpMask, "
            "interior || !inside);") in flat_text
    assert "} else if (inside) { resample::Taps<ORDER> taps;" in flat_text
    assert "interior = resample::interior<ORDER>(wt, n);" in TEXT


# ----------------------------------------------------------- float4 rows

def cubic_select(u, r):
    """cubic_row's select network over the 7 floats of two float4s."""
    odd, high = bool(r & 1), bool(r & 2)
    p = [u[j + 1] if odd else u[j] for j in range(6)]
    return [p[k + 2] if high else p[k] for k in range(4)]


def test_cubic_row_select_picks_the_taps():
    u = list(range(10, 17))
    for r in range(4):
        assert cubic_select(u, r) == u[r:r + 4]
    for line in ("for (int j = 0; j < 6; ++j) q[j] = odd ? u[j + 1] : u[j];",
                 "for (int k = 0; k < 4; ++k) v[k] = high ? q[k + 2] : q[k];",
                 "if (r != 0) hi = __ldg(reinterpret_cast<const float4*>"
                 "(row + 4));",
                 "const int r = wt.base[2] & 3;",
                 "Float4Row{r});",
                 "first_tap(vol, wt, plane, pitch, r)",
                 "(t.base[2] - shift));"):
        assert line in TEXT, line


@pytest.mark.parametrize("width", range(1, 41))
def test_float4_rows_stay_inside_a_padded_row(width):
    """For every interior first tap x0 of a cubic row, the aligned float4s
    read lie inside the row's padded width (and inside the row itself
    where the width is a multiple of 4), and cover the 4 taps."""
    pitch = padded_width(width)
    for x0 in range(0, width - 3):
        r = x0 & 3
        start = x0 - r
        last = start + (7 if r else 3)
        assert start % 4 == 0 and last < pitch
        assert start <= x0 and x0 + 3 <= last


def test_no_fma_contraction_and_the_shared_arithmetic():
    assert '#include "resample_taps.cuh"' in TEXT
    for text in (TEXT, HEADER):
        assert not re.search(r"\bfmaf?\s*\(|__fmaf?_r|__fmul_r[dzu]\b"
                             r"|fmad", text)
    # the fast path's sum is the header's, beside tap_sum
    assert ("acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w_zy, t.w[2][ix]), "
            "v[ix]));") in HEADER
    assert HEADER.count(
        "const float w_zy = __fmul_rn(t.w[0][iz], t.w[1][iy]);") == 2
    assert ("acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w_zy, t.w[2][ix]), "
            "v));") in HEADER
    assert TEXT.count("resample::interior_sum<ORDER, Index>(") == 2
    assert "acc" not in TEXT
    assert "-use_fast_math" not in " ".join(_build.NVCC_FLAGS)


# -------------------------------------------------------------- wrapper

def test_vector_rows_needs_aligned_rows_and_their_padding():
    assert vector_rows(pitched(torch.zeros(5, 6, 10)))
    assert vector_rows(torch.zeros(5, 6, 12))
    assert not vector_rows(torch.zeros(5, 6, 10))
    assert not vector_rows(torch.zeros(5, 6, 13)[..., :12])
    # rows aligned, but the storage ends before the last row's padding
    short = torch.zeros(5 * 6 * 12 - 2).as_strided((5, 6, 10), (72, 12, 1))
    assert not vector_rows(short)
    # rows 16 bytes apart but the first off a 16-byte boundary
    assert not vector_rows(torch.zeros(5 * 6 * 12 + 4)[1:].as_strided(
        (5, 6, 10), (72, 12, 1)))


def test_launch_signature_matches_the_wrapper():
    flat = re.sub(r"\s+", " ", TEXT)
    entry = flat[flat.index('extern "C" int affine_resample_launch('):]
    params = entry[entry.index("(") + 1:entry.index(")")].split(",")
    assert len(params) == len(kernel_module.ARGTYPES) == 18
    assert params[13].strip() == "int vector_rows"
    assert params[14].strip() == "int deep"
    assert params[16].strip() == "unsigned long long* counts"


def fast_path_share(matrices, vol_shape, out_shape=None,
                    patch=FLAT_PATCH) -> float:
    """The share of the in-range output voxels of a cubic launch
    ('constant') whose warp takes the kernel's interior fast path, by
    tiling the output with ``patch``: every in-range voxel of the patch
    has all its taps inside the volume."""
    taps, first = 4, -1
    out_shape = tuple(vol_shape if out_shape is None else out_shape)
    p = tuple(patch)
    pad = [(-n) % k for n, k in zip(out_shape, p)]
    fast = total = 0
    for m in matrices.reshape(-1, 4, 4):
        s = affine_coords(out_shape, m)
        inside = torch.ones(out_shape, dtype=torch.bool)
        interior = torch.ones_like(inside)
        for a in range(3):
            inside &= (s[a] >= 0) & (s[a] <= vol_shape[a] - 1)
            base = torch.floor(s[a]) + first
            interior &= (base >= 0) & (base + taps <= vol_shape[a])
        edge = torch.nn.functional.pad(inside & ~interior,
                                       (0, pad[2], 0, pad[1], 0, pad[0]))
        nz, ny, nx = (e // k for e, k in zip(edge.shape, p))
        warp_edge = edge.view(nz, p[0], ny, p[1], nx, p[2]).any(
            dim=5).any(dim=3).any(dim=1)
        for a, k in enumerate(p):
            warp_edge = warp_edge.repeat_interleave(k, dim=a)
        slow = warp_edge[:out_shape[0], :out_shape[1], :out_shape[2]]
        fast += int((inside & ~slow).sum())
        total += int(inside.sum())
    return fast / max(total, 1)


def warp_path_counts(vol_shape, m, order, out_shape, patch,
                     mode="constant"):
    """(fast, edge): the in-range voxels of a launch of matrix ``m`` that
    the kernel's warps compute on each path, by its own mapping: each
    warp's lanes from thread_voxels, the warp's vote over its lanes (cubic
    alone takes the fast path)."""
    s = affine_coords(out_shape, torch.from_numpy(m)).numpy()
    taps, first = (2, 0) if order == 1 else (4, -1)
    voxels = KERNEL_VOXELS[order]
    bx, by, bz = grid_of(out_shape, KERNEL_BRICK, voxels)
    z, y, x, here = thread_voxels(np.arange(bx * by * bz), out_shape, patch,
                                  KERNEL_BRICK, voxels)
    # one warp's lanes for one of a thread's voxels
    z, y, x, here = (np.moveaxis(a.reshape(-1, 32, voxels), 2,
                                 1).reshape(-1, 32) for a in (z, y, x, here))
    zc, yc, xc = (np.minimum(a, o - 1) for a, o in zip((z, y, x),
                                                       out_shape))
    inside = here.copy()
    inner = np.ones_like(here)
    for a in range(3):
        sa = s[a][zc, yc, xc]
        if mode == "constant":
            inside &= (sa >= 0) & (sa <= vol_shape[a] - 1)
        else:
            inside &= (sa > -0.5) & (sa < vol_shape[a] - 0.5)
        base = np.floor(sa) + first
        inner &= (base >= 0) & (base + taps <= vol_shape[a])
    fast_warp = (inner | ~inside).all(axis=1, keepdims=True) & (order == 3)
    fast = int((inside & fast_warp).sum())
    return fast, int(inside.sum()) - fast


@pytest.mark.parametrize("order", [3])
def test_fast_path_share_follows_the_warp_vote(order):
    """fast_path_share's patch tiling against the kernel's own mapping of
    a cubic launch; trilinear counts every in-range voxel on the edge
    path."""
    vol_shape, out_shape = (30, 33, 41), (21, 26, 37)
    center = tuple(n / 2 for n in vol_shape)
    for m in (transform_matrix(rotation=(20, 35, -50), rotation_order="sxyz",
                               center=center),
              transform_matrix(rotation=(0, 30, 0), rotation_order="rzxz",
                               center=center),
              translation_matrix((1.0, -2.0, 0.5)), np.eye(4)):
        m = m.astype(np.float32)
        for patch in (FLAT_PATCH, DEEP_PATCH):
            got = fast_path_share(torch.from_numpy(m), vol_shape,
                                  out_shape, patch)
            fast, edge = warp_path_counts(vol_shape, m, order, out_shape,
                                          patch)
            assert got == pytest.approx(fast / (fast + edge), abs=1e-12)
            assert 0.0 < got <= 1.0
            fast, edge = warp_path_counts(vol_shape, m, 1, out_shape, patch)
            assert fast == 0 and edge > 0
