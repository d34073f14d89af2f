"""Template matching's local sigma map under a rotated mask
(``kernels/match_sigma.py``).

On the CPU: the plain version after torch's inverse along y is bit for bit
the matcher's former tail (kept here as ``_former_tail``); its floor: a flat
region scores 0, a map of negative ``w`` has the largest value 0 and
scores 0 everywhere, a ``w`` exactly at the floor scores 0 and the next
float above it does not; the wrapper's route by width and device and its
checks; torch emulations of the kernel's C2R in both designs, pinned to
the source's constants (the pairs ``F[k]``, ``conj(F[H - k])``, the roots
``W^k``, the inverse FFT of ``X / 2`` points through ``match_zpass``'s
passes of radix 16, whose source ``match_fft.cuh`` both kernels include;
the shared-memory design's Stockham passes or Bluestein's convolution of
``X / 2`` points, or of ``X`` for an odd width), are ``torch.fft.irfft`` at
every width of the register design and at widths of every kind of the
shared-memory design.  The card tests (marker ``cuda``, skipped without a
CUDA device) hold the kernel to the plain version at tm512's (256, 512,
512) and at small shapes of widths of each design, its floor cases, its
launch counts and its refusal of a width past it.  They import no JAX;
on the card's machine::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_match_sigma.py -q
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from voltools_tpu_torch.kernels import match_sigma as ms
from voltools_tpu_torch.kernels import match_zpass as zp
from voltools_tpu_torch.models import matching

from test_torch_match_zpass import (RADIX, _emulated_fft,
                                    _emulated_shared_fft)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / ms.SOURCE
HEADER = SOURCE.parent / "match_fft.cuh"
FLOOR = matching.SIGMA_FLOOR ** 2
# the widths of the register design
WIDTHS = [2 ** k for k in range(7, 12)]
# widths of the shared-memory design: every width to 70 but 128's, even
# ones of radices 2, 3, 5 and a prime to 89 (180, 960, 1000, 178), odd
# ones (255, 2025, 2047 = 23 89), and Bluestein's (194, 2042: X / 2 = 97,
# 1021; 2039, 1993: odd primes)
# the shared-memory design's largest radix of Stockham's passes alone
# (Bluestein's passes keep 16)
STOCKHAM_RADIX = 8
SHARED_WIDTHS = (list(range(1, 71)) + [
    178, 180, 194, 255, 960, 1000, 1993, 2025, 2039, 2042, 2046, 2047])
# (Z, Y, X): odd depths and heights, a height that is not a multiple of
# the kernel's 8 rows a CTA, an odd width and one that is no power of two
SHAPES = [(5, 13, 128), (3, 8, 36), (4, 6, 33), (2, 9, 180)]


def _moments(shape, seed=3, n=137.25, flat=False):
    """SZ's outputs for known moments, laid out as the matcher keeps
    them, and ``n``: mean' random and mean_sq' such that ``w = N n *
    mean_sq' - mean'^2`` is a random positive map (0 on the first plane
    with ``flat``), each given by its spectrum along y and x."""
    rng = np.random.default_rng(seed)
    voxels = math.prod(shape)
    mean = rng.standard_normal(shape) * voxels * n * 0.3
    w = rng.uniform(0.5, 2.0, shape) * (voxels * n) ** 2
    if flat:
        w[0] = 0.0
    mean_sq = (w + mean ** 2) / (voxels * n)
    laid = []
    for real in (mean, mean_sq):
        ft = torch.fft.rfftn(torch.from_numpy(real), dim=(1, 2),
                             norm="forward")
        laid.append(matching._spectral_layout(shape, torch.complex128,
                                              "cpu").copy_(ft))
    return laid[0], laid[1], torch.tensor(n, dtype=torch.float32)


def _y_inverted(*spectra):
    return [torch.fft.ifft(s, dim=1, norm="forward") for s in spectra]


def _former_tail(mean, w, n, shape):
    """``TemplateMatcher._local_inv`` after the spectral pass, as it was
    before the kernel: both inverses along y and x, the scale, addcmul_,
    the float32 copy, the floor, rsqrt_ and masked_fill_."""
    mean = matching._irfft_yx(mean, shape)
    w = matching._irfft_yx(w, shape)
    w.mul_(math.prod(shape) * n.double()).addcmul_(mean, mean, value=-1.0)
    del mean
    w = w.to(torch.float32)
    low = w <= matching.SIGMA_FLOOR ** 2 * w.max().clamp_min(0.0)
    return w.rsqrt_().masked_fill_(low, 0.0)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_the_plain_version_is_the_former_tail_bit_for_bit(shape, flat):
    mean, mean_sq, n = _moments(shape, flat=flat)
    want = _former_tail(mean, mean_sq, n, shape)
    got = ms.plain_match_sigma(*_y_inverted(mean, mean_sq), n, shape[2],
                               FLOOR)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(want))
    # the wrapper's CPU path is the plain version
    again = ms.match_sigma(*_y_inverted(mean, mean_sq), n, shape[2], FLOOR)
    assert torch.equal(_bits(again), _bits(want))
    if flat:
        assert bool((got[0] == 0).all()) and bool((got[1:] > 0).all())


def _exact(w_rows, shape, n=1.0, mean=None):
    """Moments, inverted along z and y, whose rows are constant along x
    (only the zero frequency), so that the C2R is exact: ``w`` is
    ``w_rows`` ((Z, Y) float64, each a float32 value) for ``N`` a power
    of two and ``mean'`` whose squares are exact."""
    voxels = math.prod(shape)
    half = shape[2] // 2 + 1
    mean = np.zeros(shape[:2]) if mean is None else mean
    out = []
    for rows in (mean, (w_rows + mean ** 2) / (voxels * n)):
        t = torch.zeros(shape[:2] + (half,), dtype=torch.complex128)
        t[:, :, 0] = torch.from_numpy(rows)
        out.append(t)
    return out[0], out[1], torch.tensor(n, dtype=torch.float32)


def _floor_cases(shape):
    """(name, moments, the map's zeros, the largest w) of the floor's
    cases, each row constant along x."""
    grid = shape[:2]
    f32 = np.float32
    top = float(f32(1.0))
    at_floor = float(f32(FLOOR) * f32(top))
    above = float(np.nextafter(f32(at_floor), f32(1.0)))
    rows = np.full(grid, 0.25)
    rows[0, 0] = top
    rows[0, 1] = at_floor
    rows[0, 2] = above
    rows[1, :] = 0.0                              # a flat row
    low = np.zeros(grid, bool)
    low[0, 1] = low[1, :] = True
    negative = -np.linspace(1.0, 2.0, math.prod(grid)).reshape(grid)
    # a mean with mean'^2 = N n mean_sq' exactly: w 0, no rounding
    flat_mean = np.full(grid, 8.0)
    return [("floor", _exact(rows, shape), low, top),
            ("negative", _exact(negative, shape), np.ones(grid, bool), 0.0),
            ("flat", _exact(np.zeros(grid), shape, mean=flat_mean),
             np.ones(grid, bool), 0.0)]


@pytest.mark.parametrize("case", range(3))
def test_the_floors_cases_on_the_cpu(case):
    shape = (2, 8, 16)
    name, moments, low, top = _floor_cases(shape)[case]
    got = ms.plain_match_sigma(*moments, shape[2], FLOOR)
    zero = (got == 0).all(dim=2).numpy()
    assert (zero == low).all(), name
    assert not bool(torch.isnan(got).any()), name
    kept = got[torch.from_numpy(~low)]
    assert bool((kept > 0).all()), name
    if name == "floor":
        assert float(got[0, 0, 0]) == pytest.approx(1.0 / math.sqrt(top))
        assert float(got[0, 2, 0]) > 0.0


def test_supported_routes_each_width():
    for width in range(1, ms.MAX_WIDTH + 1):
        assert ms.supported(width, "cuda"), width
        assert ms.supported(width, torch.device("cuda", 1)), width
        assert not ms.supported(width, "cpu"), width
        want = ("registers" if width in WIDTHS else
                "bluestein" if zp.bluestein_length(ms.points(width))
                else "shared")
        assert ms.design(width) == want, width
    for width in (0, -2, ms.MAX_WIDTH + 1, 4096):
        assert not ms.supported(width, "cuda"), width
    assert ms.REGISTER_WIDTHS == (WIDTHS[0], WIDTHS[-1])
    assert ms.MAX_WIDTH == 2048
    # the points of a row's FFT: X / 2 for an even width, X for an odd one
    assert [ms.points(w) for w in (1, 2, 33, 36, 2047, 2048)] == [
        1, 1, 33, 18, 2047, 1024]
    # each kind, by name: a power of two below the register design, a
    # width that is no power of two, an odd width, X / 2 or X a prime
    # above MAX_DIRECT
    for width, want in ((64, "shared"), (36, "shared"), (33, "shared"),
                        (180, "shared"), (178, "shared"), (194, "bluestein"),
                        (97, "bluestein"), (2039, "bluestein"),
                        (2042, "bluestein"), (512, "registers")):
        assert ms.design(width) == want, width


def test_the_wrappers_checks():
    mean, mean_sq, n = _y_inverted(*_moments((2, 8, 16))[:2]) + [
        torch.tensor(3.0)]
    with pytest.raises(ValueError, match="complex128"):
        ms.match_sigma(mean.to(torch.complex64), mean_sq, n, 16, FLOOR)
    with pytest.raises(ValueError, match="one layout"):
        ms.match_sigma(mean, mean_sq.contiguous(), n, 16, FLOOR)
    with pytest.raises(ValueError, match="entries along x"):
        ms.match_sigma(mean, mean_sq, n, 18, FLOOR)
    with pytest.raises(ValueError, match="one float32 value"):
        ms.match_sigma(mean, mean_sq, n.double(), 16, FLOOR)
    with pytest.raises(ValueError, match="one float32 value"):
        ms.match_sigma(mean, mean_sq, torch.ones(2), 16, FLOOR)
    with pytest.raises(TypeError):
        ms.match_sigma(mean, mean_sq, 3.0, 16, FLOOR)


def _emulated_c2r(f):
    """The kernel's C2R of each column of ``f`` ((H + 1, C) complex128,
    the half-spectrum of X = 2 H points): F[0] and F[H] taken real, the
    pairs E = F[k] + conj(F[H - k]) and O = W^k (F[k] - conj(F[H - k])),
    W = exp(2 pi i / X), Z = E + i O, the source's inverse FFT of H points
    (``match_zpass``'s passes of radix 16), x[2m] and x[2m + 1] the real
    and imaginary parts of z[m]."""
    h = f.shape[0] - 1
    f = f.clone()
    f[0] = f[0].real
    f[h] = f[h].real
    k = torch.arange(h)
    a, b = f[k], f[h - k].conj()
    roots = torch.polar(torch.ones(h, dtype=torch.float64),
                        math.pi * k.double() / h).unsqueeze(1)
    e, o = a + b, (a - b) * roots
    z = _emulated_fft(e + 1j * o, inverse=True)
    return torch.stack([z.real, z.imag], dim=1).reshape(2 * h, -1)


@pytest.mark.parametrize("width", WIDTHS)
def test_the_kernels_c2r_is_the_irfft(width):
    rng = np.random.default_rng(width)
    half = width // 2 + 1
    # a DC and a Nyquist entry with imaginary parts too: a C2R drops them
    f = torch.from_numpy(rng.standard_normal((half, 3))
                         + 1j * rng.standard_normal((half, 3)))
    want = torch.fft.irfft(f, n=width, dim=0, norm="forward")
    got = _emulated_c2r(f)
    assert float((got - want).abs().max()) <= 1e-13 * float(
        want.abs().max())


def _emulated_shared_c2r(f, width):
    """The shared-memory design's C2R of each column of ``f`` ((X / 2 + 1,
    C) complex128, the half-spectrum of X = ``width`` points): for an even
    width the pairs E and O of the register design and the inverse FFT of
    X / 2 points, x[2m] and x[2m + 1] the real and imaginary parts of z[m];
    for an odd one the Hermitian row (F[0] taken real, conj(F[X - k])
    above X / 2) and its inverse FFT of X points, x the real part; each FFT
    the design's Stockham passes (radix ``STOCKHAM_RADIX`` at most) or
    Bluestein's convolution (its passes radix 16 at most)."""
    half = width // 2
    f = f.clone()
    f[0] = f[0].real
    if width % 2 == 0:
        f[half] = f[half].real
        k = torch.arange(half)
        a, b = f[k], f[half - k].conj()
        roots = torch.polar(torch.ones(half, dtype=torch.float64),
                            math.pi * k.double() / half).unsqueeze(1)
        z = _emulated_shared_fft((a + b) + 1j * ((a - b) * roots), True,
                                 STOCKHAM_RADIX)
        return torch.stack([z.real, z.imag], dim=1).reshape(width, -1)
    row = torch.cat([f, f[1:].flip(0).conj()])
    return _emulated_shared_fft(row, True, STOCKHAM_RADIX).real


@pytest.mark.parametrize("width", SHARED_WIDTHS)
def test_the_shared_designs_c2r_is_the_irfft(width):
    rng = np.random.default_rng(width)
    half = width // 2 + 1
    f = torch.from_numpy(rng.standard_normal((half, 2))
                         + 1j * rng.standard_normal((half, 2)))
    want = torch.fft.irfft(f, n=width, dim=0, norm="forward")
    got = _emulated_shared_c2r(f, width)
    assert float((got - want).abs().max()) <= 1e-12 * max(
        1.0, float(want.abs().max()))


def test_the_emulation_takes_the_sources_constants():
    text = SOURCE.read_text()
    header = HEADER.read_text()
    # both kernels take their FFTs from one header, which the tests of
    # match_zpass emulate
    for source in (text, (ROOT / zp.SOURCE).read_text()):
        assert '#include "match_fft.cuh"' in source
        assert "void fft(" not in source and "void pass(" not in source
        assert "constexpr int kRadix" not in source
    assert "__device__ __forceinline__ void fft(" in header
    assert re.search(r"constexpr int kRadix = (\d+);", header)[1] == str(
        RADIX)
    lo = int(re.search(r"constexpr int kMinLog2 = (\d+);", text)[1])
    hi = int(re.search(r"constexpr int kMaxLog2 = (\d+);", text)[1])
    assert (2 << lo, 2 << hi) == ms.REGISTER_WIDTHS
    top = int(re.search(r"constexpr int kMaxWidth = (\d+);", text)[1])
    assert top == ms.MAX_WIDTH
    # the shared-memory design's largest radices, as the emulation takes
    # them: Stockham's passes alone, and Bluestein's
    assert re.search(r"constexpr int kStockhamRadix = (\d+);", text)[1] == \
        str(STOCKHAM_RADIX)
    assert re.search(r"constexpr int kBluesteinRadix = (\d+);", text)[1] == \
        "16"
    assert "args.passes = radix_plan(len, args.radices, kTop);" in text
    assert zp.radices(256, STOCKHAM_RADIX) == [8, 8, 4]
    assert zp.radices(90, STOCKHAM_RADIX) == [2, 3, 3, 5]
    for line in ("? launch_shared<kStockhamRadix, kStockhamBlocks>(",
                 ": launch_shared<kBluesteinRadix, kBluesteinBlocks>("):
        assert line in text, line
    # the pairs, the roots W^k and the C2R's real DC and Nyquist entries
    for line in ("double2 b = exch[(H - k) * kRows + c];      // F[H - k]",
                 "b.y = -b.y;",
                 "const double2 o = cmul(csub(a, b), roots[k]);",
                 "v[q] = double2{e.x - o.y, e.y + o.x};",
                 "sincospi(static_cast<double>(p) / H, &s, &co);",
                 "roots[p] = C{co, s};",
                 "fft<double2, H, true, kRows>(v, exch, tw, j, c);"):
        assert line in text, line
    # the shared-memory design: the same pairs, the Hermitian row of an
    # odd width, the points and Bluestein's length as the wrapper's
    for line in ("C b = conj(buf1[(p - k) * pitch + c]);      // conj(F[H - k])",
                 "const C o = cmul(csub(a, b), roots[k]);",
                 "v = C{e.x - o.y, e.y + o.x};",
                 ": conj(buf1[(width - k) * pitch + c]);",
                 "sincospi(static_cast<double>(q) / p, &s, &co);",
                 "const int p = even ? width / 2 : width;",
                 "for (len = 1; len < 2 * p - 1;) len *= 2;",
                 "if (chirp) v = cmul(conj(v), __ldg(chirp + k));",
                 "if (chirp) v = conj(cmul(v, __ldg(chirp + m)));",
                 "const double x = even && (t & 1) ? v.y : v.x;"):
        assert line in text, line
    # w in today's order: the scale, then a fused -mean' mean' + it
    assert "__fma_rn(-mean[q].x, mean[q].x, __dmul_rn(sq[q].x," in text
    assert "__fma_rn(-mean, mean, __dmul_rn(x, scale))" in text


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _on_card(*tensors):
    return [t.to("cuda") for t in tensors]


def _card_against_plain(shape, seed=3):
    mean, mean_sq, n = _on_card(*_moments(shape, seed))
    moments = _y_inverted(mean, mean_sq)
    launches = ms._build.launches()
    before = (launches.get(ms.NAME, 0), launches.get(ms.FINISH_NAME, 0))
    got = ms.match_sigma(*moments, n, shape[2], FLOOR)
    torch.cuda.synchronize()
    launches = ms._build.launches()
    assert (launches[ms.NAME], launches[ms.FINISH_NAME]) == (
        before[0] + 1, before[1] + 1)
    want = ms.plain_match_sigma(*moments, n, shape[2], FLOOR)
    return got, want


# w's float64 rounding in the row's transform (a few units of 2^-52 of
# the row, against w's float32 rounding at 2^-24) and rsqrt's last place:
# a few units of the last place of each voxel's 1 / sqrt(w)
CARD_RTOL = 8 * 2.0 ** -24


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512, 512)] + [
    (3, 13, w) for w in WIDTHS + [1, 2, 33, 36, 64, 97, 180, 194, 960,
                                  2039, 2042, 2047]] + [(2, 70, 180)])
def test_on_the_card_the_kernel_is_its_plain_version(card, shape):
    got, want = _card_against_plain(shape)
    assert got.shape == shape and got.is_contiguous()
    assert bool((want > 0).all())
    err = float(((got - want).abs() / want).max())
    assert err <= CARD_RTOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 36, 33])
@pytest.mark.parametrize("case", range(3))
def test_on_the_card_the_floors_cases(card, case, width):
    # the register design and the shared-memory design's Stockham passes,
    # even and odd: a row with only F[0] is transformed exactly
    shape = (2, 8, width)
    name, moments, low, _ = _floor_cases(shape)[case]
    moments = _on_card(*moments)
    got = ms.match_sigma(*moments, shape[2], FLOOR).cpu()
    want = ms.plain_match_sigma(*moments, shape[2], FLOOR).cpu()
    # rows constant along x: the C2R and w are exact, so the maps are
    assert torch.equal(_bits(got), _bits(want)), name
    assert ((got == 0).all(dim=2).numpy() == low).all(), name


@pytest.mark.cuda
def test_on_the_card_a_width_past_the_kernel_raises(card):
    width = ms.MAX_WIDTH + 1
    mean, mean_sq, n = _on_card(*_y_inverted(*_moments((1, 2, width))[:2]),
                                torch.tensor(2.0))
    with pytest.raises(ValueError, match="a width of 1 to 2048"):
        ms.match_sigma(mean, mean_sq, n, width, FLOOR)
