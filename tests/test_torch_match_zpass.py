"""Template matching's spectral pass along z (``kernels/match_zpass.py``).

On the CPU: the plain version, completed by the inverse along y and x, is
the correlation ``irfftn(rfftn(placed) * spectrum)`` within rounding, with
one spectrum (complex64) and two (complex128), over windows that wrap,
odd widths, depths that are not powers of two and a box as deep as the
volume; torch emulations of the kernel's two designs, pinned to the
source's constants, are ``torch.fft.fft`` / ``ifft``: the register
design's passes of radix 16 (which points a thread holds, the butterflies
a pass gives it, the exchange's indices, the twiddles' indices and the
radix-2 stages inside a pass) at every power of two it takes, and the
shared-memory design's Stockham passes of mixed radix (the radix plan, the
butterflies' indices, the twiddles' and the roots' indices in the table,
the paired direct sums of a prime radix) and Bluestein's convolution for
a large prime factor, at every column length to 64 and many to 2048;
Bluestein's tables; the wrapper's checks; the path by depth and device;
the CPU's maps bit for bit the plain passes', and within rounding the
whole-grid correlation's on both mask paths, its counter
``match.zpass_products`` 1 and 3 an orientation.  The card tests (marker
``cuda``, skipped without a CUDA device) hold the kernel to the plain
version in both dtypes at lengths of both designs, and the matcher on
the card to the CPU's within the cells' score limit at a depth of each
design.  They import no JAX; on
the card's machine::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_match_zpass.py -q
"""

import cmath
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from voltools_tpu_torch import TemplateMatcher
from voltools_tpu_torch.kernels import match_update as mu
from voltools_tpu_torch.kernels import match_zpass as zp
from voltools_tpu_torch.models import matching
from voltools_tpu_torch.utils import trace

SOURCE = Path(__file__).resolve().parents[1] / zp.SOURCE
RADIX = 16
POINTS = [2 ** k for k in range(6, 11)]
# lengths of the shared-memory design: every radix it has, primes above 7
# (direct sums) and above MAX_DIRECT (Bluestein's, to L = 4096), the
# largest, and a power of two past the register design
SHARED_POINTS = ([n for n in range(1, 65) if n not in POINTS]
                 + [96, 100, 140, 142, 180, 194, 243, 250, 254, 300, 343,
                    360, 384, 500, 625, 640, 729, 1000, 1021, 1458, 1536,
                    2038, 2047, 2048])
# (volume shape, box): windows that wrap on every axis, odd widths, depths
# of both designs, a box as deep as the volume, a box of one plane
CASES = [((64, 40, 36), (12, 12, 12)),
         ((60, 24, 21), (9, 7, 5)),
         ((45, 16, 33), (45, 5, 3)),
         ((256, 9, 10), (1, 4, 6))]
DTYPES = [(torch.float32, 1, 1e-5), (torch.float64, 2, 1e-12)]


def _placed_volume(box, shape, dtype, seed=5):
    """A random box point-reflected about its centre into a zero volume of
    ``shape``, wrapped; the box, the volume and the centre."""
    rng = np.random.default_rng(seed)
    tmpl = torch.from_numpy(rng.standard_normal(box)).to(dtype)
    centre = tuple(b // 2 for b in box)
    volume = torch.zeros(shape, dtype=dtype)
    volume.view(-1)[matching._placed(tmpl, shape, centre, reflect=True)] = \
        tmpl.reshape(-1)
    return tmpl, volume, centre


def _spectra(shape, dtype, count, seed=6):
    rng = np.random.default_rng(seed)
    half = (shape[0], shape[1], shape[2] // 2 + 1)
    return [torch.from_numpy(rng.standard_normal(half)
                             + 1j * rng.standard_normal(half)).to(
        dtype.to_complex()) for _ in range(count)]


@pytest.mark.parametrize("dtype,count,rtol", DTYPES)
@pytest.mark.parametrize("shape,box", CASES)
def test_the_plain_version_then_y_and_x_is_the_correlation(shape, box,
                                                           dtype, count,
                                                           rtol):
    spectra = _spectra(shape, dtype, count)
    tmpl, volume, centre = _placed_volume(box, shape, dtype)
    ft = torch.fft.rfftn(volume)
    want = [torch.fft.irfftn(ft * s, s=shape, norm="forward")
            for s in spectra]
    rows, planes = matching._forward_buffers(box, shape, dtype, "cpu")
    rows.view(-1).index_copy_(
        0, matching._placed(tmpl, rows.shape, centre, reflect=True),
        tmpl.reshape(-1))
    planes = matching._pruned_planes(
        rows, planes, zp.window(box[1], centre[1], shape[1]))
    laid = [matching._spectral_layout(shape, s.dtype, "cpu").copy_(s)
            for s in spectra]
    outs = [torch.empty_like(s) for s in laid]
    zp.plain_match_zpass(planes, laid, outs, centre[0])
    for out, w in zip(outs, want):
        got = matching._irfft_yx(out, shape)
        assert got.shape == shape and got.dtype == dtype
        assert got.is_contiguous()
        err = float((got - w).abs().max()) / float(w.abs().max())
        assert err <= rtol, err


def _root16(p, inverse):
    """exp(-+2 pi i p / 16), as the source's ``rotate`` applies it."""
    return cmath.exp((1j if inverse else -1j) * 2 * math.pi * p / 16)


def _emulated_dft(a, inverse):
    """The source's ``dft``: radix-2 Stockham stages over the r points of
    a pass's butterfly, in registers."""
    r, ns = len(a), 1
    while ns < r:
        b = [None] * r
        for t in range(r // 2):
            k = t % ns
            d = (t // ns) * ns * 2 + k
            x0, x1 = a[t], a[t + r // 2] * _root16(k * 8 // ns, inverse)
            b[d], b[d + ns] = x0 + x1, x0 - x1
        a, ns = b, ns * 2
    return a


def _emulated_fft(x, inverse):
    """The source's ``fft`` of each column of ``x`` ((N, C) complex128):
    thread j of a column holds points j + q T (T = N / RADIX) in v[j][q];
    each pass of radix r (RADIX, then what is left) runs the butterflies
    jj = j + m T of thread j on its own points v[j][m + k RADIX / r],
    twiddled by table entry (jj % Ns) (N / (Ns r)) k, and writes through
    the exchange at (jj / Ns) Ns r + jj % Ns + k Ns, or, on the last pass,
    back to the thread's own points."""
    n = x.shape[0]
    threads = n // RADIX
    p = torch.arange(n, dtype=torch.float64)
    table = torch.polar(torch.ones_like(p), -2 * math.pi * p / n)
    v = [[x[j + q * threads] for q in range(RADIX)] for j in range(threads)]
    ns = 1
    while ns < n:
        r = min(RADIX, n // ns)
        per, step, last = RADIX // r, n // (ns * r), ns * r == n
        exch = [None] * n
        for j in range(threads):
            own = list(v[j])
            for m in range(per):
                jj = j + m * threads
                a = [v[j][m + k * per] for k in range(r)]
                if ns > 1:
                    base = (jj % ns) * step
                    for k in range(1, r):
                        w = table[base * k]
                        a[k] = a[k] * (w.conj() if inverse else w)
                a = _emulated_dft(a, inverse)
                d = (jj // ns) * ns * r + jj % ns
                for k in range(r):
                    if last:
                        assert d + k * ns == j + threads * (m + k * per)
                        own[m + k * per] = a[k]
                    else:
                        exch[d + k * ns] = a[k]
            v[j] = own
        if not last:
            assert all(e is not None for e in exch)
            v = [[exch[j + q * threads] for q in range(RADIX)]
                 for j in range(threads)]
        ns *= r
    return torch.stack([v[z % threads][z // threads] for z in range(n)])


def test_the_emulation_takes_the_sources_constants():
    # the source and the FFTs it includes
    text = SOURCE.read_text() + (SOURCE.parent / "match_fft.cuh").read_text()
    assert re.search(r"constexpr int kRadix = (\d+);", text)[1] == str(RADIX)
    assert re.search(r"constexpr int kPoints = (\d+);", text)[1] == str(
        RADIX)
    lo = int(re.search(r"constexpr int kMinLog2 = (\d+);", text)[1])
    hi = int(re.search(r"constexpr int kMaxLog2 = (\d+);", text)[1])
    assert (2 ** lo, 2 ** hi) == zp.REGISTER_POINTS
    assert POINTS == [2 ** k for k in range(lo, hi + 1)]
    top = int(re.search(r"constexpr int kMaxPoints = (\d+);", text)[1])
    assert top == zp.MAX_POINTS == max(SHARED_POINTS)
    # the pass radix: RADIX while at least RADIX points are left
    assert "N / Ns >= kRadix ? kRadix : N / Ns" in text
    # the shared-memory design's radix plan, as zp.radices emulates it
    plan = text[text.index("int radix_plan("):]
    plan = plan[:plan.index("\n}\n")]
    assert "args.passes = radix_plan(len, args.radices);" in text
    assert "int radix_plan(int n, int* radices, int top = 16) {" in plan
    for line in ("while (n % top == 0) add(top);",
                 "for (int r = top / 2; r >= 2; r /= 2) {",
                 "if (n % r == 0) add(r);",
                 "for (int f = 3; n > 1; f += 2) {",
                 "while (n % f == 0) add(f);"):
        assert line in plan, line
    # the compile-time butterflies; any other radix takes the direct sums
    cases = sorted(int(r) for r in re.findall(r"case (\d+):", text))
    assert cases == SMALL_RADICES
    # Bluestein's length, as bluestein_length gives it
    assert "for (len = 1; len < 2 * n - 1;) len *= 2;" in text


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", POINTS)
def test_the_kernels_passes_are_the_fft(n, inverse):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, 3))
                         + 1j * rng.standard_normal((n, 3)))
    got = _emulated_fft(x, inverse)
    want = (torch.fft.ifft(x, dim=0, norm="forward") if inverse
            else torch.fft.fft(x, dim=0))
    assert float((got - want).abs().max()) <= 1e-13 * float(
        want.abs().max())


SMALL_RADICES = [2, 3, 4, 5, 7, 8, 16]


def _emulated_shared_fft(x, inverse, top=16):
    """The shared-memory design's DFT of each column of ``x`` ((N, C)
    complex128): the Stockham passes of N (radix ``top`` at most), or,
    where N has a prime factor above ``MAX_DIRECT``, Bluestein's: the
    chirp w times the convolution, by the passes of L (radix 16 at most),
    of the column times w with the filter, whose spectrum over L is the
    tables'; the inverse conj(DFT(conj(x)))."""
    n = x.shape[0]
    length = zp.bluestein_length(n)
    if length is None:
        return _emulated_stockham(x, inverse, top)
    if inverse:
        return _emulated_shared_fft(x.conj(), False).conj()
    tables = zp.chirp_tables(n, torch.complex128, "cpu")
    w, filt = tables[:n].unsqueeze(1), tables[n:].unsqueeze(1)
    a = x.new_zeros((length,) + tuple(x.shape[1:]))
    a[:n] = x * w
    c = _emulated_stockham(_emulated_stockham(a, False) * filt, True)
    return w * c[:n]


def _emulated_stockham(x, inverse, top=16):
    """The shared-memory design's ``fft_shared`` of each column of ``x``
    ((N, C) complex128): for each radix r of ``zp.radices(N, top)``, with ns
    the points of the sub-transforms so far, butterfly b < N / r takes
    inputs b + k N / r, twiddled by table entry (b % ns) (N / (ns r)) k;
    its DFT (radix-2 stages for a power of two; direct sums with the roots
    at table entries m N / r for 3, 5, 7; for a larger prime the paired
    sums of ``prime_pass``) goes to (b / ns) ns r + b % ns + k ns."""
    n = x.shape[0]
    p = torch.arange(n, dtype=torch.float64)
    table = torch.polar(torch.ones_like(p), -2 * math.pi * p / n)
    if inverse:
        table = table.conj()
    src, ns = x, 1
    for r in zp.radices(n, top):
        m = n // r
        step = m // ns
        b = torch.arange(m)
        q = b % ns
        dst = torch.empty_like(src)
        if r in SMALL_RADICES:
            a = [src[b + k * m] for k in range(r)]
            if ns > 1:
                a = [a[0]] + [a[k] * table[q * step * k].unsqueeze(1)
                              for k in range(1, r)]
            if r & (r - 1) == 0:
                out = _emulated_dft(a, inverse)
            else:
                roots = [table[j * (n // r)] for j in range(r)]
                out = [sum(a[i] * roots[i * k % r] for i in range(r))
                       for k in range(r)]
        else:
            # the prime pass: inputs twiddled and paired, u_i = x_i +
            # x_{r-i}, v_i = x_i - x_{r-i}; outputs k and r - k as x_0 +
            # sum_i (c u_i +- i s v_i), c + i s the root at entry i k m
            h = (r - 1) // 2
            i = torch.arange(1, h + 1).view(-1, 1)
            xi = src[b + i * m] * table[q * step * i].unsqueeze(-1)
            xr = src[b + (r - i) * m] * table[q * step * (r - i)].unsqueeze(
                -1)
            u, v = xi + xr, xi - xr                          # (i, b, C)
            k = torch.arange(h + 1).view(-1, 1)
            roots = table[(i.view(1, -1) * k * m) % n]        # (k, i)
            cu = torch.einsum("ki,ibc->kbc", roots.real.to(u.dtype), u)
            sv = 1j * torch.einsum("ki,ibc->kbc", roots.imag.to(v.dtype), v)
            x0 = src[b].unsqueeze(0)
            plus, minus = x0 + cu + sv, x0 + cu - sv
            out = [plus[kk] if kk <= h else minus[r - kk]
                   for kk in range(r)]
        d = (b - q) * r + q
        for k in range(r):
            dst[d + k * ns] = out[k]
        src, ns = dst, ns * r
    return src


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SHARED_POINTS)
def test_the_shared_designs_passes_are_the_fft(n, inverse):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, 2))
                         + 1j * rng.standard_normal((n, 2)))
    got = _emulated_shared_fft(x, inverse)
    want = (torch.fft.ifft(x, dim=0, norm="forward") if inverse
            else torch.fft.fft(x, dim=0))
    assert float((got - want).abs().max()) <= 1e-12 * max(
        1.0, float(want.abs().max()))


def test_the_radix_plan_is_the_lengths_factors():
    for n in range(1, zp.MAX_POINTS + 1):
        plan = zp.radices(n)
        assert math.prod(plan) == n
        length = zp.bluestein_length(n)
        if length is None:
            assert max(plan, default=1) <= max(zp.MAX_DIRECT, 16)
        else:
            assert 2 * n - 1 <= length < 4 * n - 2 and length <= 4096
            assert length & (length - 1) == 0
            assert any(r > zp.MAX_DIRECT for r in plan)
            plan = zp.radices(length)
        # the source's kMaxPasses
        assert len(plan) <= 12
        odd = [r for r in plan if r % 2]
        assert odd == sorted(odd) and all(
            r in SMALL_RADICES or all(r % f for f in range(2, r))
            for r in plan)
    assert zp.radices(2048) == [16, 16, 8]
    assert zp.radices(180) == [4, 3, 3, 5]
    assert zp.radices(142) == [2, 71]
    assert zp.bluestein_length(194) == 512 and zp.bluestein_length(142) is None
    assert zp.bluestein_length(2038) == 4096


def test_bluesteins_tables_are_the_chirp_and_its_filters_spectrum():
    n = 2 * 97
    tables = zp.chirp_tables(n, torch.complex128, "cpu")
    assert zp.chirp_tables(n, torch.complex128, "cpu") is tables
    length = zp.bluestein_length(n)
    assert tables.shape == (n + length,)
    z = np.arange(n)
    w = np.exp(-1j * np.pi * z.astype(np.float64) ** 2 / n)
    assert np.abs(tables[:n].numpy() - w).max() <= 1e-12
    b = np.zeros(length, complex)
    b[:n] = w.conj()
    b[length - n + 1:] = w.conj()[1:][::-1]
    assert np.abs(tables[n:].numpy() - np.fft.fft(b) / length).max() <= 1e-12
    low = zp.chirp_tables(n, torch.complex64, "cpu")
    assert low.dtype == torch.complex64 and torch.equal(
        low, tables.to(torch.complex64))


def test_the_path_follows_the_depth_and_the_device():
    for n in (1, 24, 45, 64, 180, 256, 300, 1021, 1024, 2048):
        assert zp.supported(n, "cuda") and zp.supported(n, "cuda:1")
        assert not zp.supported(n, "cpu")
    for n in (0, 2049, 4096):
        assert not zp.supported(n, "cuda")
    # every device runs one structure: the forward stops at the planes
    rng = np.random.default_rng(1)
    tm = TemplateMatcher(rng.standard_normal((60, 20, 18)).astype(
        np.float32), rng.standard_normal((6, 6, 6)).astype(np.float32),
        np.ones((6, 6, 6), np.float32), device="cpu")
    assert len(tm._buffers) == 2
    assert tm._forward().shape == (6, 20, 10)


def _check_error(match, **change):
    dtype = change.pop("dtype", torch.complex64)
    count = zp.SPECTRA[dtype]
    planes = torch.zeros((4, 8, 5), dtype=dtype)
    spectra = [torch.zeros((64, 8, 5), dtype=dtype) for _ in range(count)]
    outs = [torch.zeros((64, 8, 5), dtype=dtype) for _ in range(count)]
    args = {"planes": planes, "spectra": spectra, "outs": outs, "centre": 2}
    args.update(change)
    with pytest.raises((ValueError, TypeError), match=match):
        zp.match_zpass(**args)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    _check_error("complex64 or complex128",
                 planes=torch.zeros((4, 8, 5)),
                 spectra=[torch.zeros((64, 8, 5))],
                 outs=[torch.zeros((64, 8, 5))])
    _check_error("takes 1 spectra", spectra=[torch.zeros(
        (64, 8, 5), dtype=torch.complex64)] * 2)
    _check_error("takes 2 spectra", dtype=torch.complex128,
                 spectra=[torch.zeros((64, 8, 5), dtype=torch.complex128)],
                 outs=[torch.zeros((64, 8, 5), dtype=torch.complex128)])
    _check_error("is torch.complex128", spectra=[torch.zeros(
        (64, 8, 5), dtype=torch.complex128)])
    _check_error("one shape and one layout", outs=[torch.zeros(
        (5, 64, 8), dtype=torch.complex64).permute(1, 2, 0)])
    _check_error("do not fit", planes=torch.zeros((4, 8, 6),
                                                  dtype=torch.complex64))
    _check_error("do not fit", planes=torch.zeros((65, 8, 5),
                                                  dtype=torch.complex64))
    _check_error("do not fit", planes=torch.zeros((4, 8, 5),
                                                  dtype=torch.complex64),
                 spectra=[torch.zeros((3, 8, 5), dtype=torch.complex64)],
                 outs=[torch.zeros((3, 8, 5), dtype=torch.complex64)])
    _check_error("is not a plane", centre=4)
    _check_error("must be a torch tensor", planes=np.zeros((4, 8, 5)))
    shared = torch.zeros((64, 8, 5), dtype=torch.complex64)
    _check_error("share memory", spectra=[shared], outs=[shared])


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_the_wrapper_on_the_cpu_is_the_plain_version(dtype):
    shape, box = (64, 10, 9), (7, 4, 4)
    count = zp.SPECTRA[dtype]
    rng = np.random.default_rng(9)
    planes = torch.from_numpy(rng.standard_normal((box[0], 10, 5))
                              + 1j).to(dtype)
    spectra = _spectra(shape, dtype.to_real(), count)
    got = [torch.empty_like(s) for s in spectra]
    want = [torch.empty_like(s) for s in spectra]
    before = dict(zp._build.launches())
    zp.match_zpass(planes, spectra, got, 3)
    assert zp._build.launches()[zp.NAME] == before[zp.NAME]
    zp.plain_match_zpass(planes, spectra, want, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _ellipsoid(box, semi_axes):
    g = np.arange(box) - box // 2
    axes = np.meshgrid(g, g, g, indexing="ij")
    e = np.sqrt(sum((a / s) ** 2 for a, s in zip(axes, semi_axes)))
    return np.exp(-0.5 * np.maximum(e - 1.0, 0.0) ** 2 * 9).astype(
        np.float32)


def _sphere(box, radius):
    g = np.arange(box) - box // 2
    axes = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(sum(a ** 2 for a in axes)) <= radius).astype(np.float32)


def _match_data(shape=(64, 24, 22), box=10, orientations=3, seed=12):
    from portbench import traffic
    rng = np.random.default_rng(seed)
    tomogram = rng.standard_normal(shape).astype(np.float32)
    template = rng.standard_normal((box,) * 3).astype(np.float32)
    ms = traffic.rotation_pool(rng, orientations, (box,) * 3)
    return tomogram, template, ms


MASKS = {"spherical": lambda box: _sphere(box, box // 2 - 1),
         "ellipsoid": lambda box: _ellipsoid(box, (4.0, 2.5, 2.0))}


def _counted(tm, ms):
    keys = ("match.orientations", "match.transforms", "match.zpass_products")
    before = trace.counts()
    trace.start()
    try:
        tm.match(ms)
    finally:
        trace.stop()
    after = trace.counts()
    return {k: after.get(k, 0) - before.get(k, 0) for k in keys}


def _orientation_terms(tm, mat):
    """The template placed for orientation ``mat`` in ``tm``'s rows (and,
    for a rotated mask, the mask in its float64 rows), ``1 / (N n sigma)``
    for ``_local_inv``'s arguments, as ``_score`` computes them."""
    if tm.spherical:
        t, mask, n = tm._template(mat), None, None
    else:
        mask = tm._mask_sv.affine(mat, output=tm._mask_box)
        n = mask.sum()
        t = tm._template(mat, mask, n)
    tm._rows.view(-1).index_copy_(0, tm._place, t.view(-1))
    return t, mask, n


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_on_the_cpu_the_maps_are_the_plain_passes(mask):
    tomogram, template, ms = _match_data()
    m = MASKS[mask](template.shape[0])
    tm = TemplateMatcher(tomogram, template, m, device="cpu")
    assert tm.spherical == (mask == "spherical")
    moved = _counted(tm, ms)
    scores, indices = tm.result()
    spherical = mask == "spherical"
    assert moved == {"match.orientations": 3,
                     "match.transforms": 3 * (2 if spherical else 5),
                     "match.zpass_products": 3 * (1 if spherical else 3)}
    # the same orientations through the pieces, in the order they run
    want = (torch.full(tm.shape, -math.inf), torch.full(tm.shape, -1,
                                                        dtype=torch.int32))
    for k, mat in enumerate(ms):
        _, rotated, n = _orientation_terms(tm, mat)
        product = torch.empty_like(tm._spectrum)
        zp.plain_match_zpass(tm._forward(), [tm._spectrum], [product],
                             tm.centre[0])
        cc = matching._irfft_yx(product, tm.shape)
        inv = tm._inv if spherical else tm._local_inv(rotated, n)
        mu.plain_match_update(cc, inv, *want, k)
    assert np.array_equal(scores.view(np.int32), want[0].numpy().view(
        np.int32))
    assert np.array_equal(indices, want[1].numpy())


def _whole_grid_maps(tm, ms):
    """The maps of ``ms`` from the correlations on the whole grid:
    ``irfftn(rfftn(placed) * spectrum)`` for the template and, under a
    rotated mask, the mask's moments in float64 the same way."""
    shape = tm.shape
    best = (torch.full(shape, -math.inf), torch.full(shape, -1,
                                                     dtype=torch.int32))
    for k, mat in enumerate(ms):
        t, rotated, n = _orientation_terms(tm, mat)
        placed = torch.zeros(shape)
        placed.view(-1)[matching._placed(t, shape, tm.centre,
                                         reflect=True)] = t.reshape(-1)
        cc = torch.fft.irfftn(torch.fft.rfftn(placed) * tm._spectrum,
                              s=shape, norm="forward")
        if tm.spherical:
            inv = tm._inv
        else:
            placed = torch.zeros(shape, dtype=torch.float64)
            placed.view(-1)[matching._placed(rotated, shape, tm.centre,
                                             reflect=True)] = \
                rotated.reshape(-1).double()
            ft = torch.fft.rfftn(placed)
            mean = torch.fft.irfftn(ft * tm._spectrum_wide, s=shape,
                                    norm="forward")
            w = torch.fft.irfftn(ft * tm._spectrum_sq_wide, s=shape,
                                 norm="forward")
            w = (w * (math.prod(shape) * n.double()) - mean.square()).to(
                torch.float32)
            low = w <= matching.SIGMA_FLOOR ** 2 * w.max().clamp_min(0.0)
            inv = w.rsqrt().masked_fill_(low, 0.0)
        mu.plain_match_update(cc.contiguous(), inv, *best, k)
    return best[0].numpy(), best[1].numpy()


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("depth", [64, 45])
def test_the_spectral_pass_agrees_with_the_whole_grid_correlation(mask,
                                                                   depth):
    tomogram, template, ms = _match_data(shape=(depth, 24, 22))
    m = MASKS[mask](template.shape[0])
    tm = TemplateMatcher(tomogram, template, m, device="cpu")
    assert tm._correlation().is_contiguous()
    tm.match(ms)
    scores, indices = tm.result()
    want, index = _whole_grid_maps(tm, ms)
    assert np.abs(scores - want).max() <= 1e-5 * np.abs(want).max()
    # indices agree wherever the best is not a near tie of two
    # orientations
    assert (indices != index).mean() <= 0.01


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", POINTS + SHARED_POINTS)
def test_on_the_card_the_kernel_is_its_plain_version(card, n, dtype):
    height, half = 40, 19
    depth = min(11, n)
    gen = torch.Generator(device="cuda").manual_seed(n)
    planes = torch.randn((depth, half, height), dtype=dtype,
                         generator=gen, device="cuda").permute(0, 2, 1)
    shape = (n, height, 2 * half - 2)
    spectra = [matching._spectral_layout(shape, dtype, "cuda").copy_(
        torch.randn((n, height, half), dtype=dtype, generator=gen,
                    device="cuda")) for _ in range(zp.SPECTRA[dtype])]
    got = [torch.full_like(s, math.nan) for s in spectra]
    want = [torch.empty_like(s) for s in spectra]
    before = zp._build.launches()[zp.NAME]
    zp.match_zpass(planes, spectra, got, depth // 2)
    torch.cuda.synchronize()
    assert zp._build.launches()[zp.NAME] == before + 1
    zp.plain_match_zpass(planes, spectra, want, depth // 2)
    eps = torch.finfo(dtype.to_real()).eps
    # two FFTs' rounding: a few units a level; a prime radix p's direct
    # sums round as a level of sqrt(p) terms; Bluestein's four FFTs of L
    length = zp.bluestein_length(n)
    levels = (2 * math.log2(length) if length else
              sum(math.sqrt(r) if r > 16 else 1 for r in zp.radices(n)))
    for g, w in zip(got, want):
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= 10 * eps * max(1.0, levels, math.log2(n)), err


@pytest.mark.cuda
def test_on_the_card_a_depth_past_the_kernel_raises(card):
    planes = torch.zeros((4, 8, 5), dtype=torch.complex64, device="cuda")
    spectra = [torch.zeros((zp.MAX_POINTS + 1, 8, 5), dtype=torch.complex64,
                           device="cuda")]
    with pytest.raises(ValueError, match="points along z"):
        zp.match_zpass(planes, spectra, [torch.empty_like(spectra[0])], 2)
    with pytest.raises(ValueError, match="depth of at most"):
        TemplateMatcher(torch.zeros((zp.MAX_POINTS + 1, 8, 8),
                                    device="cuda"),
                        torch.ones((2, 2, 2)), torch.ones((2, 2, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("depth", [64, 45])
def test_on_the_card_the_matcher_agrees_with_the_cpu(card, mask, depth):
    tomogram, template, ms = _match_data(shape=(depth, 24, 22),
                                         orientations=4)
    m = MASKS[mask](template.shape[0])
    cpu = TemplateMatcher(tomogram, template, m, device="cpu")
    cpu.match(ms)
    tm = TemplateMatcher(tomogram, template, m, device="cuda")
    tm.match(ms[:1])
    tm.reset()
    before = zp._build.launches()[zp.NAME]
    moved = _counted(tm, ms)
    spherical = mask == "spherical"
    assert moved["match.zpass_products"] == 4 * (1 if spherical else 3)
    assert zp._build.launches()[zp.NAME] - before == 4 * (
        1 if spherical else 2)
    (scores, _), (want, _) = tm.result(), cpu.result()
    # the cells' limit on max_rel_err (portbench/cells/tm512-*.json)
    assert np.abs(scores - want).max() <= 1e-3 * np.abs(want).max()
