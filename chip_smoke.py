#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``voltools_tpu_torch``) on one GPU.

Run from the repository root, on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It imports torch, numpy, scipy and the port only (never JAX, never
``voltools_tpu``), and prints one JSON line per phase, flushed:

1. card   -- the ``nvidia-smi`` name and power limit, torch, CUDA and nvcc
   versions;
2. build  -- ``nvcc`` builds the six kernels, ``csrc/affine_resample.cu``
   (the walk port, A: warp patches, a cubic interior fast path and float4
   rows), ``csrc/affine_slab.cu`` (the slab port, B),
   ``csrc/backproject.cu`` (the reconstructions' back-projection, C: a
   tile's projection rows staged in shared memory by TMA) and
   ``csrc/partial_sample.cu`` (the sharded paths' per-slab partial sample,
   D: D1 the stream body's ring, in one launch a shard or a launch a
   step, D2 the mesh SIRT's forward, on a line path for tilt series),
   ``csrc/match_update.cu`` (template matching's update),
   ``csrc/match_zpass.cu`` (template matching's spectral pass along z),
   ``csrc/match_sigma.cu`` (the local sigma map under a rotated mask),
   ``tools/backproject_baseline.cu`` (C's row-gather path before its
   redesign, timed beside it in phase 7) and
   ``tools/partial_sample_baseline.cu`` (D before its redesign, timed
   beside it in phase 10), in parallel, each timed, with registers and
   spills;
3. parity -- A against its plain torch version on the card, bit for bit
   (``torch.equal``; and atol 5e-5 off knife edges, as before): order {1,
   3} x mode {constant, border} x cval {0, 1.5}, on 250^3, (40, 48, 56) and
   shapes with an extent of 1, each on the contiguous and the pitched
   volume and both of A's warp patches, over two sets: random 'sxyz'
   rotations about size/2 plus a translate, a scale and a shear, and a
   near-edge set (identity, whole- and half-voxel translations, a scale
   just off 1, rotations by 90 and 3 degrees about the centre) whose warps
   reach the edges and knife edges, so that both of A's cubic paths (the
   interior fast path and the edge path) are held against the plain
   version: A counts on the device the in-range voxels that took its fast
   path; per case they must not exceed the in-range voxels of the plain
   version's coordinates, trilinear must count none, and over the phase
   some but not all of cubic's in-range voxels must take it; a batch of 16
   and a write into a preallocated tensor;
4. parity_slab -- B against its plain version (atol 5e-5 off knife edges)
   and against A (``torch.equal``: the two share their per-voxel
   arithmetic), order x mode x cval as above, on pitched volumes (widths
   56, 250, 80 and 29: two of them not a multiple of 4), on the matrices of
   ``tests/test_pallas.py`` at (40, 48, 56), the 41-tilt series about each
   axis and the random set of phase 3 at 250^3, the extent-1 shapes, a
   batch and an into-buffer write; each launch plans by the box rule
   (``slab_plan``), and B's overflow counter stays 0;
4b. parity_backproject -- C against its plain version on the card, bit
   for bit (``torch.equal``), on both of its paths: the reconstruction's
   41-tilt series at 250^3 (projection axis 0), series along projection
   axes 1 and 2, the general path (``_force_general``, and a series that
   takes it by its geometry), an odd shape (37, 50, 61), one tilt, a
   volume shard's slab-shifted matrices, rows partly and wholly off the
   projection, and a row-gather matrix scaled 30x whose rows span more
   than the first tile's window holds (the wrapper takes a smaller tile);
   each row-gather case with its tile; no tap may fall outside its
   window (C's device count, ``window_misses``, must stay 0);
4c. parity_partial_sample -- D1 against its plain version on the card,
   bit for bit (``torch.equal``): the stream body's ring through D1's
   ring entry (SHARDS launches a ring, one a shard) and through its plain
   steps (``_stream_body(m, plain=True)``), and D1's per-step entry called
   directly, chained over each shard's ring (SHARDS x SHARDS launches), on
   4 shards of a 250^3 volume (the last shard padded: 250 planes in 4 x
   63) and of (37, 50, 61) (4 x 10), order {1, 3} x mode {constant,
   border with cval 1.5}, for two random rotations, a half-voxel shift
   (every stencil straddles two planes, slab boundaries included) and a
   scale whose taps pass the global edges; D2 against
   ``plain_partial_project`` per shard (one launch each), within the
   order of a float32 sum, 2 (n_p - 1) 2**-24 of the plain projection of
   the slab's magnitudes (``sum_order_atol``): the reconstruction's
   41-tilt series along projection axis 0 at 250^3 and the odd shape's
   series (both on the line path, each also against the general kernel,
   ``_force_general=True``, bit for bit), random rotations along axes 1
   and 2 (the general kernel);
4d. parity_rows, rows_times -- B's row path (trilinear launches whose
   every matrix leaves the row axis alone) against B's general kernel
   (``_force_general=True``), bit for bit, and against the plain version
   (ATOL), in both item orders: the reconstruction's 41-tilt series at
   250^3 in its launches (34 and 7) and at the tomogram's (256, 512,
   512) in the forward's launches of 8, both edges and cvals at 250^3,
   an odd shape (37, 50, 61) into another output shape; the row path's
   launch count (``"affine_slab.rows"``) one a launch; then the device time per tilt of the row path in both
   orders beside the general kernel's and the launches' least time (the
   source read once a launch, every output written once) at 250^3 and at
   the tomogram's shape;
4e. parity_match_update, match_update_times -- template matching's
   update kernel against its plain version (the four torch kernels it
   replaces) at the tomogram's (256, 512, 512), bit for bit (the scores'
   bit patterns): a run of orientations from the maps ``reset()`` leaves,
   with ``inv`` 0 at a tenth of the voxels, one correlation repeated
   (ties) and one with NaN; each launch's improved-voxel count against
   the indices it changed; then its device time beside its bound (the
   three maps read once; every voxel written, after a reset), the plain
   four torch kernels and the share of voxels each orientation improves,
   over a sweep of fresh correlations from a reset; then the kernel's
   max-only entry (the random-phase correction's noise map) the same way
   at tm1024-rpc's (512, 1024, 1024), its launches counted, beside its
   bound (cc, inv and the noise map read once) and its two torch kernels;
4f. matcher_launches -- ``TemplateMatcher.match`` at tm512's shapes (a
   (256, 512, 512) tomogram, a 48^3 template): one call of 16
   orientations from a reset, the launch counters set to 0 just before,
   launches the update kernel once an orientation and the spectral pass
   once an orientation; then each orientation a call, its update bit for
   bit the plain version's on the matcher's own correlation; then the
   same under an ellipsoidal mask (tm512-nsmask's): the spectral pass
   twice an orientation (the correlation, the sigma's two products); and
   for both masks, at tm512's depth and at a depth of 180 (not a power of
   two: the kernel's shared-memory design), the maps after the call
   against those of the same call with the spectral pass's plain version
   on the card (``max_rel_err`` of the scores over their largest, at most
   1e-4, and the indices that differ), the kernel's launches counted;
   then ``TemplateMatcher(..., random_phase_correction=True)`` at tm512's
   shapes under both masks and at tm1024-rpc's (a (512, 1024, 1024)
   tomogram, a 96^3 template): one call of 16 orientations, counters set
   to 0 before it: the max-only entry and the update once an orientation,
   the spectral pass twice (three times under the ellipsoid), the
   rotations on A or B and no other kernel; each orientation a call, its
   noise map bit for bit the plain update's on the matcher's own noise
   correlation; the call's maps bit for bit those of the same call with
   the entry's plain version;
4g. parity_match_zpass, match_zpass_times -- the spectral pass along z
   (``csrc/match_zpass.cu``) against its plain version at tm512's shapes
   (48 planes, (256, 512, 257) spectra laid out as the matcher keeps
   them) and at a depth of 180: complex64 with one spectrum, complex128
   with two, the largest difference over the largest |plain|; then its
   device time alone beside its bound (the planes and spectra read once,
   the results written once) and the plain version's; the same at
   tm1024-rpc's (512, 1024, 1024) with a 96^3 box;
4h. parity_match_sigma, match_sigma_times -- the sigma kernel
   (``csrc/match_sigma.cu``: the C2R along x of a rotated mask's two
   moments, ``w`` and its float32 map and largest value in one launch, the
   floor and ``rsqrt`` in place in a second) at tm512-nsmask's shapes: one
   orientation's moments from a matcher under the ellipsoid into the
   kernel and into its plain version, the largest difference over each
   voxel's plain value and the voxels floored on one side only; one
   ``TemplateMatcher.match`` call of 16 orientations from a reset, each
   entry launched once an orientation, its maps against those of the same
   call with the plain version; the kernel against its plain version at
   widths of the shared-memory design (480, 255, 2042: Stockham passes
   even and odd, Bluestein's); then the device times of each entry alone
   beside its bound (the moments read once and the map written once; the
   map read and written once), the plain version's, torch's inverse along
   y and the whole tail before (torch's inverses and passes) and after;
5. main   -- the main path at 250^3 float32, through the public API:
   ``StaticVolume`` 'linear' and 'filt_bspline' on 'cuda', ``.affine`` over
   16 random rotations and ``.affine_batch`` of the same 16, and the
   one-shot ``affine(..., 'filt_bspline', device='cuda')``.  Both launch
   counters are set to 0 just before and read just after, and each must
   equal what the planner (``choose_plan``: the box rule, then the speed
   rule) gives for the same matrices; results are held against the plain
   version and scipy.ndimage;
6. tilt   -- the tilt-series path at 250^3 through the public API:
   ``TiltSeriesProjector`` 'linear' and 'filt_bspline', 41 tilts from -60
   to +60 degrees in 3 degree steps at position 1 of the 'rzxz' triple,
   then ``wbp_reconstruct`` and ``sirt_reconstruct`` (30 iterations) of a
   linear series at position 0, the geometry of
   ``examples/reconstruction.py``, with the counters set to 0 before and
   read after, A's and B's each equal to the planner's, C's 1 per WBP and
   1 + iterations per SIRT; each kernel must have run on one of the two
   paths.  Projections are held against the plain version (rotate, then
   sum) and one tilt against
   ``scipy.ndimage.affine_transform(...).sum(axis=0)``; WBP and SIRT (3
   iterations) against the same functions with the plain forward and C's
   plain version (RECON_RTOL), WBP and the 30-iteration SIRT bit for bit
   against C's plain version alone (``_plain_adjoint=True``);
7. times  -- CUDA-event times after warm-up of B and A on the same
   matrices (the projector's and the reconstruction's tilt series and the
   16 random rotations, single and batched, linear and cubic; A with the
   warp patch the planner picks, and the share of its in-range voxels on
   the interior fast path, as A counted them on the device), of the
   kernels as the planner routes each
   matrix, and the planner's choice and box voxels per output voxel for
   each set, one matrix a launch and as the path launches it, in chunks
   (the ``planner_choice`` line: whether the routed time is within 5% of
   the faster of A alone and B wherever its box fits, reported and not
   checked, as no time is); both kernels one matrix at a time beside
   B's box voxels per output voxel, the data of the planner's speed rule
   (the ``speed_rule_sweep`` line); the host's time per call of the
   planner's ``route`` and ``walk_patch``; ``StaticVolume.affine`` per
   rotation, the
   prefilters, the
   one-shot calls, the pitched copy, the projector, WBP and SIRT (with C
   and with its plain version), C alone on both paths, and the plain
   versions, beside each kernel's bound (the larger of its bytes over the
   memory rate and its least arithmetic, for this run's matrices, over the
   fp32 rate) and ``torch.nn.functional.grid_sample`` (timed only; the
   port never calls it: for C, of the 41 projections at every voxel's
   (rows, cols), then summed over the tilts); C's row-gather path in
   turns with ``tools/backproject_baseline.cu`` on the same inputs (C,
   baseline, baseline, C; the two bit for bit), with C's tile, shared
   memory a CTA, registers and the floor of a design that keeps bit
   parity (4 separate FP32 instructions a voxel a tilt); WBP at a
   tomogram's size, (256, 512, 512) from 41 projections of (512, 512), C
   against its plain version, bit for bit and timed, and C there beside
   the baseline; no window miss in the phase;
8. registration -- ``examples/registration.py``'s blob phantom at 128^3
   (a large subtomogram box; the example uses 64^3), moved by its hidden
   rigid transform through the port's ``rodrigues_matrix`` and plain
   sampler, rescaled and given noise; ``register(model='rigid',
   loss='ncc', levels=2, steps=200)`` on 'cuda', 'linear' and
   'filt_bspline', must recover the inverse transform within the bounds
   below; the linear call on 'cpu' (plain torch, the host's cores) must
   agree with the card's; ``phase_cross_correlation(upsample=10)`` on
   both; ``RegistrationResult.apply`` on 'cuda', with the launch counters
   set to 0 before the path and read after, each equal to the planner's;
   CUDA-event times of the whole ``register``, of an Adam step per level
   and of the phase correlation;
9. cpu_backends -- the native C++ backend built with g++ on the card's
   host (timed), then ``affine(..., device='cpu', cpu_backend='native')``
   and ``'scipy'`` on the main path's 250^3 volume, 2 of its rotations,
   linear and ``filt_bspline``, each held against A's output (1e-4 off
   knife edges) and timed on the host, beside the host CPU's model;
10. sharded -- the main path's volume on ``Mesh([cuda:0] * 4)``, four
   shards on the one card: ``ShardedVolume`` 'linear' and 'filt_bspline'
   through the halo body (a translation and a small rotation), the gather
   and stream bodies (the first 4 random rotations) and one 'border',
   cval 1.5 case; a 2-shard mesh's sharded prefilter; ``make_mesh()``;
   ``sharded_affine_batch`` of the 16 rotations in both orders (to A) and
   the reconstruction's 41 tilts, 11 a shard (to B), with each shard's
   ``last_dispatch()``; ``wbp_reconstruct(mesh=)`` in both modes and
   ``sirt_reconstruct(mesh=)``.  The counters are set to 0 before each
   call and must then read what ``planner.route`` gives per shard, D1's
   shards launches for a rotation through the stream body, all on its
   ring entry (and none of A or B), C's one launch per shard for each
   mesh WBP and C's and D2's shards x (1 + iterations) for the mesh SIRT,
   every D2 launch on the line path; each result is
   held against the single-device call and the plain version (SHARD_ATOL,
   SHARD_STREAM_ATOL, RECON_RTOL), the mesh reconstructions bit for bit
   against C's plain version (``_plain_adjoint=True``; the mesh SIRT at
   one iteration).  Times per call beside the single-device ones and
   beside the plain stream body and the mesh SIRT with its plain forward
   (``_plain_forward=True``), timed once, the device operations of one
   call, and the peak memory of one rotation through 'stream' and
   'gather'; D1 in the stream body's call (the call, and the device time
   of its 4 ring launches alone: events around each launch, the call
   queued behind a sleep kernel), the 16 launches of its per-step entry
   and of ``tools/partial_sample_baseline.cu`` over the same rings, and
   D2's 4 launches of a sweep on the line path, on the general kernel and
   on the baseline (the same two times for the call), in turns, beside
   their bounds (D1's function -- each source voxel a shard's taps read
   once, the output written once, each inside voxel sampled once -- and
   its per-step design's, which reads and writes the accumulator at each
   step; D2's general sample and the line geometry's bilinear one), the
   floors of a design that keeps bit parity (no contraction: each rounded
   operation of the plain order an instruction, at half the fp32 rate),
   their plain versions, what torch.profiler records of the same calls
   and ``grid_sample`` (timed only: D1 linear trilinear with zero padding
   on each slab at the shard's coordinates; D2 per tilt on each slab,
   then summed over the projection axis);
11. examples -- the port's four examples, ``examples/torch_*.py``, each
   ``main(device='cuda', figure=None)`` at its JAX counterpart's size:
   the transform at 64^3 (mirror prefilter, then A), the three projection
   levels at 96^3 (41 tilts, 'sxyz', A), the reconstruction at 64^3 (the
   projector and SIRT's forward on B, WBP and SIRT's 30 iterations on C)
   and the registration at 64^3 (2 levels of 300 Adam steps; A makes the
   moving volume and applies the result).  Each runs its pipeline twice
   and times the second pass.  The counters are set to 0 before each
   example and read after, each equal to the planner's count for its
   launches, and A, B and C must each have run.  Each kernel is held
   against its plain version at the examples' shapes: A's launches (the
   transform, the moving volume and the applied registration) against
   the plain sampler on the same input (ATOL off knife edges), the
   projections of both projectors (A at 96^3, B at 64^3) against
   ``plain_project_stack`` (two orders of a sum of n non-negative terms:
   2 (n - 1) 2**-24 of the largest projection), WBP and SIRT (C) bit for
   bit against ``_plain_adjoint=True``.  The transform is held against
   scipy too (1e-4 off knife edges), the projection levels against each
   other, the interior correlations within 1e-4 of the JAX example's, and
   the registration's recovery within 0.3 x 24 / 64 degrees and 0.05
   voxel.

The line before the last is the ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits 1 before printing a result.
"""

import ctypes
import functools
import json
import math
import os
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

SIZE = 250                 # the reference benchmark's volume, 250^3 float32
N_ROT = 16                 # rotations on the main path
TILTS = (-60.0, 61.0, 3.0)  # the examples' tilt series: 41 tilts
TILT_AXIS = 1
# the reconstruction's series: with 'rzxz' and projection axis 0, a tilt at
# position 1 turns the volume about the beam (array axis 0), so its
# projections are in-plane rotations of one image and hold no depth; at
# position 0 it turns about array axis 2, across the beam, as
# examples/reconstruction.py tilts
RECON_TILT_AXIS = 0
SIRT_ITERATIONS = 30       # as examples/reconstruction.py
ATOL = 5e-5                # kernel vs plain version, off knife edges
SCIPY_ATOL = 1e-4          # main path vs scipy.ndimage, off knife edges
# a projection sums SIZE voxels: against scipy each may be off by
# SCIPY_ATOL; against the plain version on the card the voxels agree and
# only the order of the sum may differ: n * eps * sum|x| for 250 values
# below 1 is about 2e-3
PROJ_SCIPY_ATOL = SIZE * SCIPY_ATOL
PROJ_ATOL = 2e-3
# WBP and SIRT with the kernels' forward against the plain forward, as a
# share of the largest |value|: the projections may differ in their last
# bits (sums in another order), and SIRT carries that through 30 rounds
# of sums over 41 tilts and 250 voxels
RECON_RTOL = 1e-4
KNIFE_TOL = 1e-4           # |coordinate - round(coordinate)| masked below
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_FLOPS = 67e12         # H100 SXM fp32 rate outside the tensor cores
# the least floating-point work of the function per output voxel that lands
# inside the source (an FMA counts 2): 3 coordinates of 3 FMAs (18), 3
# fractions, the weights (1 per axis for linear, 14 for cubic) and a
# separable contraction of k^3 + k^2 + k FMAs (14 linear, 84 cubic).  A
# voxel outside the source needs only its coordinates.
FLOPS_INSIDE = {1: 18 + 3 + 3 * 1 + 2 * 14, 3: 18 + 3 + 3 * 14 + 2 * 84}
FLOPS_OUTSIDE = 18
# a sleep kernel of about 50 ms at the H100's clock, long enough for the host
# to queue a whole stream-body rotation or D2 sweep behind it
SLEEP_CYCLES = 10 ** 8
# phase 8: examples/registration.py's phantom and hidden transform
# (:30-39, :49-50) in a 128^3 box, registered in 2 levels of 200 steps
REG_SIZE = 128
REG_STEPS = 200
REG_LEVELS = 2
REG_W_TRUE = (0.05, -0.07, 0.06)   # radians
REG_T_TRUE = (3.4, -2.2, 1.8)      # voxels
PCC_UPSAMPLE = 10
# recovery bounds: tests/test_registration.py's rigid test allows 0.3
# degrees on a 24^3 volume; the same displacement at the edge of a 128^3
# box is 0.3 * 24 / 128 degrees; its translation tests allow 0.05 voxel
REG_DEG_TOL = 0.3 * 24 / REG_SIZE
REG_T_TOL = 0.05
# the card's register against the CPU's on the same call
REG_W_CPU_TOL = 1e-3               # radians
REG_T_CPU_TOL = 1e-2               # voxels
REG_LOSS_RTOL = 1e-4               # the first 5 losses
# steps per timed register call, for the slope of an Adam step per level
REG_TIMED_STEPS = (5, 25)
CPU_BACKEND_ROTATIONS = 2          # phase 9: rotations of the main path
# phase 10: a mesh of SHARDS shards on the one card (a device may repeat in
# a mesh).  A shard's matrix is the single-device one with its slab shift
# added to column 3 in float32, so its coordinates round differently, by a
# few ulps of the coordinate: tests/test_parallel.py holds the halo and
# gather bodies to 3e-5 on extents below 64 (coordinate ulp 3.8e-6); at
# 250^3 the ulp is 4x that (1.5e-5 in [128, 256)), and so is the atol, off
# knife edges.  The ring stream keeps that file's 5e-4 for full 3-D
# rotations (off knife edges), the sharded prefilter its 2e-5
SHARDS = 4
N_SHARD_ROT = 4                    # the first of the main path's rotations
STREAM_CUBIC_ROTATIONS = 4         # of those, through the cubic stream
SHARD_ATOL = 4 * 3e-5
SHARD_STREAM_ATOL = 5e-4
SHARD_PREFILTER_ATOL = 2e-5
SHARD_SIRT_ITERATIONS = 3
# kernel C, the back-projection: the least floating-point work per output
# voxel a tilt.  Row-gather: a lerp (3) and the sum (1), the row coordinate
# shared by a line of voxels; general: two coordinates by one FMA each from
# the line's start (4), two fractions (2), three lerps (9) and the sum (1)
BACKPROJECT_FLOPS = {True: 4, False: 16}
TOMO_SHAPE = (256, 512, 512)       # a tomogram cryo-ET users reconstruct
# phase 4e: the orientations of the parity run and of the timed sweep,
# both from the maps reset() leaves
MATCH_RUN = 8
MATCH_SWEEP = 64
# phase 4f: tm512's template box, its mask's radius and the orientations
# of one TemplateMatcher.match call (tm512-match scores 16 a call)
MATCH_BOX = 48
MATCH_MASK_RADIUS = 20.0
MATCH_SEMI_AXES = (20.0, 12.0, 9.0)    # tm512-nsmask's ellipsoid
MATCH_CALL = 16
# phases 4f and 4g: a tomogram depth that is not a power of two
MATCH_ODD_DEPTH = 180
# phases 4e-4g: tm1024-rpc's bin-4 tomogram, its template box and its
# mask's radius, the random-phase correction's scale
RPC_SHAPE = (512, 1024, 1024)
RPC_BOX = 96
RPC_MASK_RADIUS = 40.0
# phase 4b: a row-gather matrix whose rows coordinate is scaled this much
# spans more rows than the first tile's window can hold
LARGE_SPAN_SCALE = 30.0
# C's row-gather path before its redesign, timed beside it (phase 7)
BASELINE_SOURCE = "tools/backproject_baseline.cu"
# D before its redesign, timed beside it (phase 10)
D_BASELINE_SOURCE = "tools/partial_sample_baseline.cu"
# kernel D's least work.  D1 a sampled voxel: FLOPS_INSIDE, once; D2's
# line geometry a sample: its 4 taps, each an FMA into the ray's sum with
# the line's weight (8), and a (tilt, line, plane): its two coordinates
# (3 FMAs each, 12), two fractions and their complements (4) and the 4
# weights w_z w_q (4), shared by the line's rays.  The floors of a design
# that keeps bit parity count the plain order's rounded operations, each
# an instruction at half the fp32 rate (which counts an FMA as 2): D1
# linear 53 (coordinates 18, fractions and weights 6, the tap sum 28, the
# ring's sum 1) and cubic 275 (18, 48, 208, 1); D2's general kernel 53 a
# sample (18, z offset 1, fractions 3, weights 3 + 4 + 8, taps 8, sums
# 8); its line path 8 a sample (4 products, 4 sums) and 21 a (tilt, line,
# plane) (coordinates 12, z offset 1, fractions 2, weights 2 + 4)
D2_LINE_FLOPS = {"sample": 8, "line": 20}
PARITY_OPS = {"d1": {1: 53, 3: 275}, "d2_general": 53,
              "d2_line": {"sample": 8, "line": 21}}
# SIRT against the plain forward and C's plain version: a few iterations
# (the plain forward takes about half a second a sweep at 250^3)
SIRT_REFERENCE_ITERATIONS = 3
# the matrices of tests/test_pallas.py, on its (40, 48, 56) volume
PALLAS_SHAPE = (40, 48, 56)
PALLAS_CENTER = (19.5, 23.5, 27.5)
# examples/reconstruction.py's interior correlations with its phantom,
# from the JAX package on the CPU at the example's own 64^3 and 30 SIRT
# iterations (the card's machine has no JAX); the card's must agree to
# the 4 digits the example prints
JAX_RECON_CORRELATION = {"wbp": 0.8591802546381944,
                         "sirt": 0.8797051681315219}
EXAMPLE_CORR_ATOL = 1e-4

CARD = {}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields, **CARD}), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def knife_mask(torch, m, shape, device, half=False):
    """True where a source coordinate lies within KNIFE_TOL of an integer,
    and with ``half`` of a half-integer too (the 'border' discard band);
    rows that are exactly integral have no knife edge."""
    mm = torch.as_tensor(m, dtype=torch.float64, device=device)
    grids = [torch.arange(n, dtype=torch.float64, device=device)
             for n in shape]
    i, j, k = (grids[0].view(-1, 1, 1), grids[1].view(1, -1, 1),
               grids[2].view(1, 1, -1))
    near = torch.zeros(shape, dtype=torch.bool, device=device)
    for a in range(3):
        row = mm[a]
        if bool((row == torch.round(row)).all()) and int(
                (row[:3] != 0).sum()) <= 1:
            continue
        s = row[0] * i + row[1] * j + row[2] * k + row[3]
        near |= (s - torch.round(s)).abs() < KNIFE_TOL
        if half:
            near |= (s - torch.round(s + 0.5) + 0.5).abs() < KNIFE_TOL
    return near


def errors(torch, got, want, m, half=False):
    """(max error off knife edges, max error everywhere)."""
    diff = (got.double() - want.double()).abs()
    assert torch.isfinite(got).all(), "non-finite kernel output"
    near = knife_mask(torch, m, tuple(got.shape), got.device, half)
    return (float(torch.where(near, 0.0, diff).max()), float(diff.max()))


def example_sum_atol(n, largest):
    """How far two sums of the same ``n`` non-negative float32 terms, in
    two orders, may lie apart: each lies within (n - 1) * 2**-24 of the
    exact sum, relative, which is at most ``largest``."""
    return 2 * (n - 1) * 2.0 ** -24 * largest


def matrix_set(np, transform_matrix, shape, seed):
    """Two random 'sxyz' rotations about size/2, a translate, a scale and
    a shear."""
    rng = np.random.default_rng(seed)
    center = tuple(s / 2 for s in shape)
    ms = [transform_matrix(rotation=tuple(rng.uniform(-180, 180, 3)),
                           rotation_order="sxyz", center=center)
          for _ in range(2)]
    ms.append(transform_matrix(translation=(2.37, -1.41, 0.73)))
    ms.append(transform_matrix(scale=(0.87, 1.09, 0.93), center=center))
    ms.append(transform_matrix(shear=(0.11, -0.07, 0.19), center=center))
    return np.stack(ms).astype(np.float32)


def near_edge_set(np, transform_matrix, translation_matrix, shape):
    """Matrices whose source points reach the volume's edges and knife
    edges: the identity, whole- and half-voxel translations, a scale just
    off 1 and rotations by 90 and 3 degrees about the centre."""
    center = tuple((s - 1) / 2 for s in shape)
    return np.stack([
        np.eye(4),
        translation_matrix((1.0, 0.0, -1.0)),
        translation_matrix((0.5, -0.5, 0.25)),
        transform_matrix(scale=(1.02, 0.98, 1.01), center=center),
        transform_matrix(rotation=(90, 0, 0), rotation_order="rzxz",
                         center=center),
        transform_matrix(rotation=(3, 2, 1), rotation_order="sxyz",
                         center=center),
    ]).astype(np.float32)


def pallas_cases(np, transform_matrix, translation_matrix, center):
    """The CASES of tests/test_pallas.py about ``center``."""
    return np.stack([
        np.eye(4),
        translation_matrix((1.5, -2.25, 0.75)),
        transform_matrix(scale=(1.3, 0.8, 1.1), center=center),
        transform_matrix(rotation=(10, 5, -3), rotation_order="rzxz",
                         center=center),
        transform_matrix(rotation=(0, 60, 0), rotation_order="sxyz",
                         center=center),
        transform_matrix(rotation=(170, 0, 0), rotation_order="rzxz",
                         center=center),
        transform_matrix(shear=(0.1, -0.05, 0.2), center=center),
    ]).astype(np.float32)


def tilt_series(np, transform_matrix, shape, axis):
    """The 41-tilt series about ``axis`` ('rzxz', center (n-1)/2), as
    ``TiltSeriesProjector.tilt_matrices`` builds it."""
    center = np.divide(np.subtract(shape, 1), 2, dtype=np.float32)
    ms = []
    for a in np.arange(*TILTS):
        triple = [0.0, 0.0, 0.0]
        triple[axis] = float(a)
        ms.append(transform_matrix(rotation=triple, rotation_order="rzxz",
                                   center=center))
    return np.stack(ms).astype(np.float32)


def axis_series(np, shape, axis):
    """The 41 tilts of TILTS as rotations about array ``axis``, about the
    centre (n - 1) / 2: pull-back matrices, float32."""
    i, j = [a for a in range(3) if a != axis]
    centre = (np.asarray(shape, np.float64) - 1) / 2
    ms = []
    for a in np.radians(np.arange(*TILTS)):
        m = np.eye(4)
        m[i, i], m[i, j], m[j, i], m[j, j] = (np.cos(a), -np.sin(a),
                                              np.sin(a), np.cos(a))
        m[:3, 3] = centre - m[:3, :3] @ centre
        ms.append(m)
    return np.stack(ms).astype(np.float32)


def inverses(np, ms):
    """M^-1 of each matrix, float32, as the reconstructions compute it."""
    return np.stack([np.linalg.inv(m) for m in ms]).astype(np.float32)


def backproject_bound_ms(n, out_shape, proj_shape, rowgather):
    """Least time on the card for C's back-projection of ``n`` projections
    into ``out_shape``: the larger of the bytes moved (the projections read
    once, the volume written once) over the memory rate and
    BACKPROJECT_FLOPS a voxel a tilt over the fp32 rate.  Returns (ms,
    'bytes' or 'operations')."""
    vout = out_shape[0] * out_shape[1] * out_shape[2]
    tb = 4.0 * (vout + n * proj_shape[0] * proj_shape[1]) / HBM_BYTES_PER_S
    to = BACKPROJECT_FLOPS[bool(rowgather)] * n * vout / FP32_FLOPS
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def backproject_floor_ms(n, out_shape):
    """The least time of C's row-gather path that keeps bit parity: no
    contraction, so BACKPROJECT_FLOPS separate FP32 instructions a voxel a
    tilt, at half the fp32 rate (which counts an FMA as 2)."""
    vout = out_shape[0] * out_shape[1] * out_shape[2]
    return BACKPROJECT_FLOPS[True] * n * vout / (FP32_FLOPS / 2) * 1e3


def blob_phantom(np, ndimage, n, seed=0):
    """examples/registration.py's phantom (:30-39) in an n^3 box: 14 balls
    of radius 3-8 in the middle half, Gaussian-smoothed."""
    rng = np.random.default_rng(seed)
    vol = np.zeros((n, n, n), np.float32)
    z, y, x = np.ogrid[:n, :n, :n]
    for _ in range(14):
        c = rng.integers(n // 4, 3 * n // 4, 3)
        r = rng.integers(3, 9)
        vol[(z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2 < r * r] += 1.0
    return ndimage.gaussian_filter(vol, 1.2).astype(np.float32)


def host_cpu_model():
    """The host CPU as /proc/cpuinfo names it: its model name, and its
    vendor, family, model and clock (a sandboxed host may report the model
    name as 'unknown')."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            key = key.strip()
            if not key and fields:
                break   # the first processor's block is enough
            if key in ("model name", "vendor_id", "cpu family", "model",
                       "cpu MHz"):
                fields.setdefault(key, value.strip())
    return (f"{fields.get('model name', 'unknown')} "
            f"({fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')}, {fields.get('cpu MHz', '?')} MHz)")


def event_ms(torch, fn):
    """Device time of one call of ``fn`` (CUDA events), and its result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), result


def device_ops(torch, fn):
    """(device operations -- kernels, copies -- one call of ``fn`` runs,
    the ms they keep the device busy, the host's waits on the device: CUDA
    runtime calls named ...Synchronize), as torch.profiler records them;
    None where it records no device operation."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        return None
    syncs = sum(e.name.endswith("Synchronize") for e in prof.events())
    return (len(ops), sum(e.time_range.elapsed_us() for e in ops) / 1e3,
            syncs)


def host_syncs(torch, fn):
    """The host's waits on the device in one call of ``fn``: CUDA runtime
    calls named ...Synchronize, as torch.profiler records them, the
    closing synchronize included."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.name.endswith("Synchronize") for e in prof.events())


def time_ms(torch, fn, reps, warmup=None):
    """Mean device time of ``fn`` over ``reps`` back-to-back runs, after
    ``warmup`` runs (as many as ``reps``, at least 2, unless given: the
    card's clocks rise under load)."""
    for _ in range(max(2, reps) if warmup is None else warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inside_voxels(torch, vt, shape, mats, mode="constant"):
    """Output voxels per matrix whose source point lies inside the volume
    by ``mode``'s test ('constant': [0, n - 1]; 'border': more than half a
    voxel inside), from the coordinates the kernels compute."""
    counts = []
    for m in mats:
        s = vt.ops.affine_coords(shape, m)
        inside = torch.ones(shape, dtype=torch.bool, device=s.device)
        for a in range(3):
            if mode == "constant":
                inside &= (s[a] >= 0) & (s[a] <= shape[a] - 1)
            else:
                inside &= (s[a] > -0.5) & (s[a] < shape[a] - 0.5)
        counts.append(int(inside.sum()))
    return counts


def bound_ms(order, in_shape, out_shape, inside, per_launch):
    """Least time per matrix on the card for matrices with ``inside``
    in-source output voxels each, ``per_launch`` of them per launch: for
    each launch the larger of the bytes moved (the source read once, the
    outputs written once) over the memory rate and the work of
    FLOPS_INSIDE / FLOPS_OUTSIDE over the fp32 rate.  Returns (ms per
    matrix, 'bytes' or 'operations', whichever is the larger in sum)."""
    vin = in_shape[0] * in_shape[1] * in_shape[2]
    vout = out_shape[0] * out_shape[1] * out_shape[2]
    total = t_bytes = t_ops = 0.0
    for first in range(0, len(inside), per_launch):
        group = inside[first:first + per_launch]
        tb = 4.0 * (vin + len(group) * vout) / HBM_BYTES_PER_S
        to = sum(FLOPS_INSIDE[order] * c + FLOPS_OUTSIDE * (vout - c)
                 for c in group) / FP32_FLOPS
        total += max(tb, to)
        t_bytes += tb
        t_ops += to
    return (total / len(inside) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def d1_bound_ms(torch, vt, matrices, true_shape, local, order, mode, device):
    """Least time on the card for D1 in one stream-body rotation
    (``matrices`` the shards' slab-shifted matrices), the larger of the
    bytes over the memory rate and the operations over the fp32 rate, from
    these matrices' coordinates, for the function and for the per-step
    design; and the floor of a design that keeps bit parity.

    The function (``bound_ms``): each source voxel that a shard's inside
    voxels' taps read (with ``mode``'s index rule), once per shard; each
    output voxel written once; FLOPS_INSIDE at each inside voxel, once,
    FLOPS_OUTSIDE at the others.  The per-step design
    (``per_step_bound_ms``, a launch per shard and slab): the same reads,
    the accumulator read and written where an inside voxel's z stencil
    meets a slab, cval written once at each outside voxel, FLOPS_INSIDE at
    each voxel a launch samples and FLOPS_OUTSIDE at its others.  The
    floor (``floor_ms``): the function's bytes, against PARITY_OPS at each
    inside voxel and FLOPS_OUTSIDE at the others, at half the fp32 rate.
    Returns a dict of these with what bounds each, the voxels inside, the
    voxels the per-step launches sample and the source voxels read."""
    from voltools_tpu_torch.ops.interpolation import _inside, _mirror_index
    shards = len(matrices)
    h, w = true_shape[1:]
    first, taps = (0, 2) if order == 1 else (-1, 4)
    vox = local * h * w
    step_words = ops = sampled = read_total = inside_total = 0
    for m in matrices:
        c = vt.ops.affine_coords((local, h, w), m, device=device)
        inside = _inside(c[0], c[1], c[2], true_shape, mode)
        axes = []   # per axis, per tap: (index, in range or None)
        for a, n in enumerate(true_shape):
            base = torch.floor(c[a]).to(torch.int64) + first
            axes.append([])
            for t in range(taps):
                i = base + t
                if mode == "border":
                    axes[a].append((i.clamp(0, n - 1), (i >= 0) & (i < n)))
                elif order == 3:
                    axes[a].append((_mirror_index(i, n), None))
                else:
                    axes[a].append((i.clamp(0, n - 1), None))
        del c, base, i
        read = torch.zeros(shards * vox, dtype=torch.bool, device=device)
        for z, okz in axes[0]:
            for y, oky in axes[1]:
                for x, okx in axes[2]:
                    ok = inside
                    for o in (okz, oky, okx):
                        ok = ok if o is None else ok & o
                    read[((z * h + y) * w + x)[ok]] = True
        read_total += int(read.sum())
        del read
        for j in range(shards):
            meets = torch.zeros_like(inside)
            for z, okz in axes[0]:
                own = (z >= j * local) & (z < (j + 1) * local)
                meets |= own if okz is None else own & okz
            n = int((meets & inside).sum())
            sampled += n
            step_words += 2 * n
            ops += FLOPS_INSIDE[order] * n + FLOPS_OUTSIDE * (vox - n)
        inside_total += int(inside.sum())
        step_words += int((~inside).sum())
        del axes, inside, meets
    outside_total = shards * vox - inside_total
    result = {"inside_voxels": inside_total, "voxels_sampled": sampled,
              "source_voxels_read": read_total}
    for label, words, t_ops in (
            ("bound", read_total + shards * vox,
             (FLOPS_INSIDE[order] * inside_total
              + FLOPS_OUTSIDE * outside_total) / FP32_FLOPS),
            ("per_step_bound", read_total + step_words, ops / FP32_FLOPS),
            ("floor", read_total + shards * vox,
             (PARITY_OPS["d1"][order] * inside_total
              + FLOPS_OUTSIDE * outside_total) / (FP32_FLOPS / 2))):
        t_bytes = 4.0 * words / HBM_BYTES_PER_S
        result[f"{label}_ms"] = max(t_bytes, t_ops) * 1e3
        result[f"{label}_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return result


def queued_launch_ms(torch, fn, module, name):
    """Device ms of the launches that one call of ``fn`` makes through
    ``module.name``, each between CUDA events recorded just before and
    just after it, the whole call queued behind a sleep kernel: the host's
    work between launches falls into the sleep, not between a launch's
    events.  Raises unless the host had queued the call before the sleep
    ended.  Returns the list of per-launch ms."""
    launch = getattr(module, name)
    pairs = []

    def timed(*args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = launch(*args, **kwargs)
        ev[1].record()
        pairs.append(ev)
        return out

    setattr(module, name, timed)
    try:
        sleep = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        sleep[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
        sleep[1].record()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    finally:
        setattr(module, name, launch)
    sleep_ms = sleep[0].elapsed_time(sleep[1])
    assert host_ms < sleep_ms, (name, host_ms, sleep_ms)
    return [a.elapsed_time(b) for a, b in pairs]


def queued_ms(torch, calls, before=None):
    """Device ms of each of ``calls`` (callables that launch one kernel
    each), each between CUDA events recorded just before and just after
    it, all queued behind a sleep kernel, after ``before`` (queued work
    that is not timed).  Raises unless the host had queued them before the
    sleep ended.  Returns the list of per-call ms."""
    sleep = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    pairs = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in calls]
    torch.cuda.synchronize()
    sleep[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    sleep[1].record()
    t0 = time.perf_counter()
    if before is not None:
        before()
    for call, ev in zip(calls, pairs):
        ev[0].record()
        call()
        ev[1].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = sleep[0].elapsed_time(sleep[1])
    assert host_ms < sleep_ms, (host_ms, sleep_ms)
    return [a.elapsed_time(b) for a, b in pairs]


def profiler_view(torch, fn):
    """What torch.profiler records of one call of ``fn``: its device
    events by name, and the device events in the profiler's raw (kineto)
    results, before they become function events, by name."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = Counter(e.name[:80] for e in prof.events()
                     if e.device_type == cuda)
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    raw = None if raw is None else Counter(
        e.name()[:80] for e in raw.events() if e.device_type() == cuda)
    return {"device_events": dict(events),
            "raw_device_events": None if raw is None else dict(raw)}


def launches_of(*names):
    """The launches of this process under each of ``names``, from the
    port's one store of launch counts."""
    from voltools_tpu_torch.kernels import _build
    counts = _build.launches()
    return tuple(counts[name] for name in names)


def since(before, *names):
    """The launches under ``names`` since ``before`` (their
    :func:`launches_of` then)."""
    return tuple(n - b for n, b in zip(launches_of(*names), before))


def rows_phase(torch, np, dev):
    """Phase 4d: B's row path against its general kernel, bit for bit, and
    against the plain version, in both item orders; then its device time
    per tilt beside the general kernel's and the least time, at 250^3 and
    at the tomogram's shape.  Returns the times for the kernels' line."""
    import voltools_tpu_torch as vt
    from voltools_tpu_torch.kernels import affine_slab as S
    from voltools_tpu_torch.kernels.layout import pitched, row_pitch
    from voltools_tpu_torch.kernels.planner import route
    from voltools_tpu_torch.ops.sampling import affine_sample
    from voltools_tpu_torch.utils import transform_matrix
    slab = S.affine_slab
    # the C entry's item_order: x segment first, or matrix first
    orders = {"segments": 1, "matrices": 0}
    rows_entry = S.LIBRARY.launcher("affine_rows_launch")
    rows = []

    def in_order(vol, ms_dev, order, mode="constant", cval=0.0,
                 out_shape=None, out=None):
        """The row path's launch through its C entry, its CTAs numbered
        in ``order`` in place of the one the launch would pick."""
        out_shape = tuple(out_shape or vol.shape)
        if out is None:
            out = torch.empty((len(ms_dev),) + out_shape, device=dev)
        rows_entry(
            dev, vol.data_ptr(), *vol.shape, row_pitch(vol),
            ms_dev.data_ptr(), len(ms_dev), out.data_ptr(), *out_shape,
            S._MODES[mode], float(cval), orders[order],
            S.LIBRARY.counter("overflows", dev).data_ptr())
        return out

    def check(name, vol, ms, mode="constant", cval=0.0, out_shape=None):
        shape = tuple(vol.shape)
        out_shape = tuple(out_shape or shape)
        plan = route(ms, shape, "linear", mode, out_shape).plan
        assert plan is not None and plan.rows, (name, "not a row launch")
        ms_dev = torch.from_numpy(ms).to(dev)
        want = slab(vol, ms_dev, 1, mode, cval, out_shape, plan=plan,
                    _force_general=True)
        worst = 0.0
        names = ("affine_slab", "affine_slab.rows")
        before = launches_of(*names)
        got = slab(vol, ms_dev, 1, mode, cval, out_shape, plan=plan)
        assert since(before, *names) == (1, 1), name
        assert torch.equal(got, want), (name, mode, cval)
        del got
        for order in orders:
            got = in_order(vol, ms_dev, order, mode, cval, out_shape)
            assert torch.equal(got, want), (name, order, mode, cval)
            del got
        for i in (0, len(ms) // 2, len(ms) - 1):
            plain = affine_sample(vol, ms_dev[i], "linear", mode, cval,
                                  out_shape=out_shape, prefiltered=True)
            worst = max(worst, float((want[i] - plain).abs().max()))
            assert worst <= ATOL, (name, i, worst)
        rows.append({"case": name, "shape": list(shape),
                     "out_shape": list(out_shape), "mode": mode,
                     "cval": cval, "tilts": len(ms),
                     "equal_to_general": True, "max_abs_err_plain": worst})

    gen = torch.Generator(device=dev).manual_seed(18)
    times = {}
    for shape in ((SIZE,) * 3, TOMO_SHAPE):
        vol = pitched(torch.rand(shape, generator=gen, device=dev))
        ms = tilt_series(np, transform_matrix, shape, RECON_TILT_AXIS)
        chunk = vt.StaticVolume.batch_chunk(shape)
        launches = [ms[p:p + chunk] for p in range(0, len(ms), chunk)
                    if len(ms[p:p + chunk]) >= 2]
        cases = [("constant", 0.0)]
        if shape != TOMO_SHAPE:
            cases += [("constant", 1.5), ("border", 0.0), ("border", 1.5)]
        for mode, cval in cases:
            for k, c in enumerate(launches):
                check(f"recon_{shape[0]}_launch_{k}", vol, c, mode, cval)
        # the times: every launch of the forward, back to back
        plans = [route(c, shape, "linear").plan for c in launches]
        mats = [torch.from_numpy(c).to(dev) for c in launches]
        out = torch.empty((chunk,) + shape, device=dev)
        tilts = sum(len(c) for c in launches)

        def sweep(**kw):
            for c, m, p in zip(launches, mats, plans):
                slab(vol, m, 1, out=out[:len(c)], plan=p, **kw)

        def sweep_in(order):
            for c, m in zip(launches, mats):
                in_order(vol, m, order, out=out[:len(c)])

        least = sum(bound_ms(1, shape, shape,
                             inside_voxels(torch, vt, shape, m),
                             len(m))[0] * len(m) for m in mats)
        key = "tomogram" if shape == TOMO_SHAPE else f"{shape[0]}"
        times[key] = {
            "launches": [len(c) for c in launches],
            "general_ms_per_tilt": time_ms(
                torch, lambda: sweep(_force_general=True), reps=3) / tilts,
            **{f"rows_{o}_ms_per_tilt": time_ms(
                torch, lambda o=o: sweep_in(o), reps=5) / tilts
               for o in orders},
            "rows_ms_per_tilt": time_ms(torch, sweep, reps=5) / tilts,
            "least_ms_per_tilt": least / tilts}
        del vol, out, mats
        torch.cuda.empty_cache()
    # an odd shape into another output shape, widths not a multiple of 4
    odd = (37, 50, 61)
    vol = pitched(torch.rand(odd, generator=gen, device=dev))
    ms = tilt_series(np, transform_matrix, odd, RECON_TILT_AXIS)
    for mode, cval in (("constant", 1.5), ("border", 0.0)):
        check("odd_into_other_shape", vol, ms, mode, cval, (33, 52, 70))
        check("odd", vol, ms, mode, cval)
    emit("parity_rows", cases=rows, item_orders=list(orders),
         method="the row path's launch against the general kernel's with "
         "the same plan (_force_general=True), torch.equal, and 3 tilts "
         "of each against the plain version")
    emit("rows_times", times=times, method="CUDA events around the "
         "forward's launches back to back (reps after as many warm-ups), "
         "per tilt; least: the source read once a launch and every "
         "output written once at the memory rate, or FLOPS_INSIDE at the "
         "fp32 rate, whichever is larger, per launch")
    return times


def score_diff(torch, a, b):
    """Between two (scores, indices) pairs: the largest |difference| of the
    scores over voxels whose bit patterns differ (NaN against any other
    pattern counts as infinity), the largest distance between the bit
    patterns read as int32, and the indices that differ; all 0 where the
    two are equal bit for bit."""
    bits_a, bits_b = a[0].view(torch.int32), b[0].view(torch.int32)
    differ = bits_a != bits_b
    gap = torch.where(differ, (a[0] - b[0]).abs(),
                      torch.zeros_like(a[0])).nan_to_num_(nan=float("inf"))
    bits = (bits_a.to(torch.int64) - bits_b.to(torch.int64)).abs()
    return (float(gap.max()), int(bits.max()),
            int((a[1] != b[1]).sum()))


def match_update_phase(torch, np, dev):
    """Phase 4e: template matching's update kernel against its plain
    version at the tomogram's size, bit for bit, over a run of
    orientations from a reset; its improved-voxel count; its device time
    beside its bound, the plain version and the share of voxels improved.
    Returns the numbers for the kernels' line."""
    from voltools_tpu_torch.kernels import match_update as MU
    shape = TOMO_SHAPE
    n = int(np.prod(shape))
    gen = torch.Generator(device=dev).manual_seed(21)

    def reset(maps):
        maps[0].fill_(-float("inf"))
        maps[1].fill_(-1)

    def fresh():
        maps = (torch.empty(shape, device=dev),
                torch.empty(shape, dtype=torch.int32, device=dev))
        reset(maps)
        return maps

    inv = torch.rand(shape, generator=gen, device=dev).add_(0.5)
    inv.masked_fill_(torch.rand(shape, generator=gen, device=dev) < 0.1, 0.0)
    ccs = [torch.randn(shape, generator=gen, device=dev)
           for _ in range(MATCH_RUN)]
    ccs[3] = ccs[1]                         # ties
    ccs[5].masked_fill_(torch.rand(shape, generator=gen, device=dev) < 0.01,
                        float("nan"))
    kernel, plain = fresh(), fresh()
    launches = launches_of("match_update")
    rows = []
    worst = [0.0, 0, 0]
    for k, cc in enumerate(ccs):
        MU.plain_match_update(cc, inv, *plain, k)
        before_indices = kernel[1].clone()
        before = MU.improved_voxels(dev)
        MU.match_update(cc, inv, *kernel, k)
        torch.cuda.synchronize()
        diff = score_diff(torch, kernel, plain)
        worst = [max(w, d) for w, d in zip(worst, diff)]
        assert diff == (0.0, 0, 0), ("match_update", k, diff)
        improved = MU.improved_voxels(dev) - before
        changed = int((kernel[1] != before_indices).sum())
        assert improved == changed, (k, improved, changed)
        rows.append({"orientation": k, "improved_share": improved / n})
    assert since(launches, "match_update") == (MATCH_RUN,)
    nan = int(torch.isnan(kernel[0]).sum())
    negative_zero = int(((kernel[0] == 0)
                         & torch.signbit(kernel[0])).sum())
    emit("parity_match_update", shape=list(shape), orientations=rows,
         nan_scores=nan, negative_zero_scores=negative_zero,
         max_abs_err=worst[0], max_bit_diff=worst[1],
         index_mismatch=worst[2],
         method="the kernel against plain_match_update on the card after "
         "each orientation (score_diff: max_abs_err over the scores whose "
         "bit patterns differ, max_bit_diff between the patterns as int32, "
         "index_mismatch the indices that differ; the largest over the "
         "run); improved_share the kernel's count over the voxels, equal "
         "to the indices it changed")
    del ccs, plain, before_indices

    # the times: every voxel written (after a reset), then a sweep of
    # fresh correlations from a reset, each launch timed alone
    cc = torch.empty(shape, device=dev)
    torch.randn(shape, generator=gen, out=cc)
    firsts = []
    for _ in range(5):
        reset(kernel)
        firsts.append(event_ms(
            torch, lambda: MU.match_update(cc, inv, *kernel, 0))[0])
    first_ms = sum(firsts) / len(firsts)
    reset(kernel)
    sweep, shares = [], []
    for k in range(MATCH_SWEEP):
        torch.randn(shape, generator=gen, out=cc)
        before = MU.improved_voxels(dev)
        sweep.append(event_ms(
            torch, lambda k=k: MU.match_update(cc, inv, *kernel, k))[0])
        shares.append((MU.improved_voxels(dev) - before) / n)
    plain = fresh()
    plain_ms = time_ms(torch, lambda: MU.plain_match_update(
        cc, inv, *plain, 0), reps=5)
    late = MATCH_SWEEP // 4
    times = {
        "shape": list(shape),
        "first_ms": first_ms,
        "sweep_ms": sweep,
        "sweep_mean_ms": sum(sweep) / len(sweep),
        "late_ms": sum(sweep[-late:]) / late,
        "improved_share": shares,
        "late_improved_share": sum(shares[-late:]) / late,
        "plain_ms": plain_ms,
        "max_abs_err": worst[0], "max_bit_diff": worst[1],
        "index_mismatch": worst[2],
        "bound_ms": 12.0 * n / HBM_BYTES_PER_S * 1e3,
        "bound_all_written_ms": 20.0 * n / HBM_BYTES_PER_S * 1e3,
    }
    emit("match_update_times", **times,
         method="CUDA events around each launch; first_ms: a launch on "
         "the maps reset() leaves, every voxel written (5 runs); sweep_ms: "
         f"{MATCH_SWEEP} orientations of fresh N(0, 1) correlations from "
         "a reset, late_ms the mean of the last quarter; plain_ms the four "
         "torch kernels; bound_ms cc, inv and the scores read once (12 "
         "bytes a voxel), bound_all_written_ms with a score and an index "
         "written at every voxel (20 bytes)")
    del cc, inv, kernel, plain
    torch.cuda.empty_cache()
    return times


def match_noise_update_phase(torch, np, dev):
    """Phase 4e, the update kernel's max-only entry: against its plain
    version at tm1024-rpc's (512, 1024, 1024), bit for bit, over a run of
    orientations from a reset (``inv`` 0 at a tenth of the voxels, one
    correlation repeated, one with NaN), its launches counted and the
    improved-voxel count left as it was; then its device time beside its
    bound and the plain version's.  Returns the numbers for the kernels'
    line."""
    from voltools_tpu_torch.kernels import match_update as MU
    shape = RPC_SHAPE
    n = int(np.prod(shape))
    gen = torch.Generator(device=dev).manual_seed(25)
    none = torch.zeros(1, dtype=torch.int32, device=dev)

    def fresh():
        return torch.full(shape, -float("inf"), device=dev)

    inv = torch.rand(shape, generator=gen, device=dev).add_(0.5)
    inv.masked_fill_(torch.rand(shape, generator=gen, device=dev) < 0.1, 0.0)
    kernel, plain = fresh(), fresh()
    cc, kept = torch.empty(shape, device=dev), None
    names = (MU.NOISE_NAME, MU.NAME)
    launches = launches_of(*names)
    improved = MU.improved_voxels(dev)
    worst = [0.0, 0]
    for k in range(MATCH_RUN):
        if k == 3:
            cc.copy_(kept)                  # ties
        else:
            torch.randn(shape, generator=gen, out=cc)
        if k == 1:
            kept = cc.clone()
        if k == 5:
            cc.masked_fill_(torch.rand(shape, generator=gen, device=dev)
                            < 0.01, float("nan"))
        MU.plain_match_noise_update(cc, inv, plain)
        MU.match_noise_update(cc, inv, kernel)
        torch.cuda.synchronize()
        diff = score_diff(torch, (kernel, none), (plain, none))
        worst = [max(w, d) for w, d in zip(worst, diff[:2])]
        assert diff == (0.0, 0, 0), ("match_noise_update", k, diff)
    assert since(launches, *names) == (MATCH_RUN, 0)
    assert MU.improved_voxels(dev) == improved
    nan = int(torch.isnan(kernel).sum())
    emit("parity_match_noise_update", shape=list(shape),
         orientations=MATCH_RUN, nan_scores=nan, max_abs_err=worst[0],
         max_bit_diff=worst[1],
         method="the max-only entry against plain_match_noise_update on "
         "the card after each orientation (score_diff of the noise maps, "
         "the largest over the run); its launches counted, the update's "
         "and its improved-voxel count unchanged")
    del kept, plain

    # the times: every voxel written (after a reset), then a sweep of
    # fresh correlations from a reset, each launch timed alone
    firsts = []
    for _ in range(5):
        kernel.fill_(-float("inf"))
        firsts.append(event_ms(
            torch, lambda: MU.match_noise_update(cc, inv, kernel))[0])
    kernel.fill_(-float("inf"))
    sweep = []
    for _ in range(MATCH_SWEEP):
        torch.randn(shape, generator=gen, out=cc)
        sweep.append(event_ms(
            torch, lambda: MU.match_noise_update(cc, inv, kernel))[0])
    plain = fresh()
    plain_ms = time_ms(torch, lambda: MU.plain_match_noise_update(
        cc, inv, plain), reps=5)
    late = MATCH_SWEEP // 4
    times = {
        "shape": list(shape),
        "first_ms": sum(firsts) / len(firsts),
        "sweep_mean_ms": sum(sweep) / len(sweep),
        "late_ms": sum(sweep[-late:]) / late,
        "plain_ms": plain_ms,
        "max_abs_err": worst[0], "max_bit_diff": worst[1],
        "bound_ms": 12.0 * n / HBM_BYTES_PER_S * 1e3,
        "bound_all_written_ms": 16.0 * n / HBM_BYTES_PER_S * 1e3,
    }
    emit("match_noise_update_times", **times,
         method="CUDA events around each launch; first_ms: a launch on a "
         "map reset() leaves, every voxel written (5 runs); sweep: "
         f"{MATCH_SWEEP} orientations of fresh N(0, 1) correlations from "
         "a reset, late_ms the mean of the last quarter; plain_ms the two "
         "torch kernels; bound_ms cc, inv and the noise map read once (12 "
         "bytes a voxel), bound_all_written_ms with the map written at "
         "every voxel (16 bytes)")
    del cc, inv, kernel, plain
    torch.cuda.empty_cache()
    return times


def matcher_phase(torch, np, dev, zero_launches, launch_counts):
    """Phase 4f: ``TemplateMatcher.match`` at tm512's shapes -- a (256,
    512, 512) tomogram, a 48^3 template under a spherical mask -- in one
    call of MATCH_CALL orientations from the maps ``reset()`` leaves, the
    launch counters set to 0 just before it: the update kernel and the
    spectral pass launch once an orientation.  Then the same orientations
    a call each, every update held bit for bit to the plain version's on
    the matcher's own correlation (computed again from the template it
    placed last) and ``1/sigma``.  Then the call under tm512-nsmask's
    ellipsoidal mask: the spectral pass twice an orientation.  For both
    masks, at tm512's depth and at MATCH_ODD_DEPTH, the call's maps are
    held to those of the same call with the spectral pass's plain version,
    and its launches counted.  Returns the calls' launches and the largest
    differences."""
    from voltools_tpu_torch.kernels import match_sigma as MS
    from voltools_tpu_torch.kernels import match_update as MU
    from voltools_tpu_torch.kernels import match_zpass as ZP
    from voltools_tpu_torch.models.matching import TemplateMatcher
    from voltools_tpu_torch.utils import transform_matrix
    gen = torch.Generator(device=dev).manual_seed(22)
    rng = np.random.default_rng(22)
    box = MATCH_BOX
    g = torch.arange(box, dtype=torch.float32, device=dev) - box // 2
    axes = (g.view(-1, 1, 1), g.view(1, -1, 1), g.view(1, 1, -1))
    r = sum(a.square() for a in axes).sqrt_()
    mask = (r <= MATCH_MASK_RADIUS).float()
    # tm512-nsmask's ellipsoid, a sharp edge
    ellipsoid = (sum((a / s).square() for a, s in zip(
        axes, MATCH_SEMI_AXES)) <= 1.0).float()
    template = torch.randn((box,) * 3, generator=gen, device=dev)
    tomogram = torch.randn(TOMO_SHAPE, generator=gen, device=dev)
    ms = np.stack([transform_matrix(
        rotation=tuple(rng.uniform(-180, 180, 3)), rotation_order="rzxz",
        center=(box // 2,) * 3) for _ in range(MATCH_CALL)]
    ).astype(np.float32)

    def counted_call(mask, depth=TOMO_SHAPE[0], plain=False):
        """The matcher's maps after one call of ``ms`` from a reset and
        the call's launches, for the tomogram's first ``depth`` planes;
        with ``plain`` the spectral pass is its plain version."""
        kernel = ZP.match_zpass
        if plain:
            ZP.match_zpass = ZP.plain_match_zpass
        try:
            matcher = TemplateMatcher(tomogram[:depth], template, mask,
                                      device=str(dev))
            matcher.match(ms[:1])       # builds the kernels, plans FFTs
            matcher.reset()
            torch.cuda.synchronize()
            zero_launches()
            matcher.match(ms)
            torch.cuda.synchronize()
        finally:
            ZP.match_zpass = kernel
        return matcher, launch_counts()

    matcher, counts = counted_call(mask)
    assert counts[MU.NAME] == MATCH_CALL, counts
    assert counts[ZP.NAME] == MATCH_CALL, counts
    matcher.reset()
    worst = [0.0, 0, 0]
    for k, m in enumerate(ms):
        plain = (matcher.scores.clone(), matcher.indices.clone())
        matcher.match(m)
        MU.plain_match_update(matcher._correlation(), matcher._inv, *plain,
                              k)
        diff = score_diff(torch, (matcher.scores, matcher.indices), plain)
        worst = [max(w, d) for w, d in zip(worst, diff)]
        assert diff == (0.0, 0, 0), ("TemplateMatcher", k, diff)
    del matcher, plain
    torch.cuda.empty_cache()
    matcher, ns_counts = counted_call(ellipsoid)
    assert not matcher.spherical
    assert ns_counts[MU.NAME] == MATCH_CALL, ns_counts
    assert ns_counts[ZP.NAME] == 2 * MATCH_CALL, ns_counts
    del matcher
    torch.cuda.empty_cache()
    # the kernel against its plain version in the matcher, both masks, at
    # a depth of each of the kernel's designs
    paths = {}
    for name, m, per in (("spherical", mask, 1), ("ellipsoid", ellipsoid, 2)):
        for depth in (TOMO_SHAPE[0], MATCH_ODD_DEPTH):
            maps = []
            for plain in (False, True):
                matcher, moved = counted_call(m, depth, plain)
                maps.append((matcher.scores.clone(),
                             matcher.indices.clone()))
                assert moved[ZP.NAME] == (0 if plain else per * MATCH_CALL)
                del matcher
                torch.cuda.empty_cache()
            (a, ia), (b, ib) = maps
            largest = float(b.abs().max())
            apart = (a - b).abs()
            key = f"{name} depth {depth}"
            paths[key] = {"max_rel_err": float(apart.max()) / largest,
                          "indices_differ": int((ia != ib).sum()),
                          "launches": per * MATCH_CALL}
            assert paths[key]["max_rel_err"] <= 1e-4, (key, paths[key])
            del maps, a, b, ia, ib, apart
    del tomogram
    torch.cuda.empty_cache()
    emit("matcher_launches", shape=list(TOMO_SHAPE), box=box,
         orientations=MATCH_CALL, launches=counts,
         launches_nsmask=ns_counts, max_abs_err=worst[0],
         max_bit_diff=worst[1], index_mismatch=worst[2],
         kernel_against_plain=paths,
         method="one TemplateMatcher.match call of the orientations from "
         "a reset, the counters set to 0 just before it (launches_nsmask: "
         "the same under an ellipsoidal mask); then each orientation in a "
         "call of its own, the maps after it against plain_match_update "
         "of the maps before it on the matcher's own correlation "
         "(score_diff); kernel_against_plain: the call's maps against "
         "those of the same call with the spectral pass's plain version, "
         "at tm512's depth and at a depth that is not a power of two, "
         "max_rel_err the largest |difference| of the scores over their "
         "largest |score|, indices_differ the indices that differ (near "
         "ties of two orientations), launches the kernel's in the call")
    assert counts[MU.NOISE_NAME] == ns_counts[MU.NOISE_NAME] == 0
    # the sigma kernel: none under a sphere, each entry an orientation
    # under the ellipsoid
    assert counts[MS.NAME] == counts[MS.FINISH_NAME] == 0, counts
    assert ns_counts[MS.NAME] == ns_counts[MS.FINISH_NAME] == MATCH_CALL, \
        ns_counts
    return {"launches": counts[MU.NAME], "max_abs_err": worst[0],
            "noise_launches": counts[MU.NOISE_NAME],
            "max_bit_diff": worst[1], "index_mismatch": worst[2],
            "zpass_launches": {"match": counts[ZP.NAME],
                               "match_nsmask": ns_counts[ZP.NAME]},
            "sigma_launches": {
                "match": counts[MS.NAME] + counts[MS.FINISH_NAME],
                "match_nsmask": {e: ns_counts[e] for e in (
                    MS.NAME, MS.FINISH_NAME)}},
            "kernel_against_plain": paths}


def matcher_rpc_phase(torch, np, dev, zero_launches, launch_counts):
    """Phase 4f under the random-phase correction: ``TemplateMatcher(...,
    random_phase_correction=True)`` at tm512's shapes under a spherical and
    an ellipsoidal mask, and at tm1024-rpc's (a (512, 1024, 1024)
    tomogram, a 96^3 template, a sphere of radius 40).  One call of
    MATCH_CALL orientations from a reset, the counters set to 0 just
    before it: the max-only entry and the update once an orientation, the
    spectral pass twice (three times under the ellipsoid), the template's
    and the noise template's rotations (and the mask's) on A or B, no other
    kernel.  Then each orientation a call, the noise map held bit for bit
    to the plain version's update on the matcher's own noise correlation
    (computed again from the noise template it placed last) and
    ``1/sigma``.  Then the call's maps (scores, indices, noise, the
    corrected map) against those of the same call on the same matcher with
    the entry's plain version, bit for bit.  Returns the launches and the
    largest differences."""
    from voltools_tpu_torch.kernels import affine_resample as K
    from voltools_tpu_torch.kernels import affine_slab as S
    from voltools_tpu_torch.kernels import match_sigma as MS
    from voltools_tpu_torch.kernels import match_update as MU
    from voltools_tpu_torch.kernels import match_zpass as ZP
    from voltools_tpu_torch.models import matching
    from voltools_tpu_torch.utils import transform_matrix
    gen = torch.Generator(device=dev).manual_seed(26)
    rng = np.random.default_rng(26)

    def masks(box, radius):
        g = torch.arange(box, dtype=torch.float32, device=dev) - box // 2
        axes = (g.view(-1, 1, 1), g.view(1, -1, 1), g.view(1, 1, -1))
        sphere = (sum(a.square() for a in axes).sqrt_() <= radius).float()
        ellipsoid = (sum((a / s).square() for a, s in zip(
            axes, MATCH_SEMI_AXES)) <= 1.0).float()
        return sphere, ellipsoid

    sphere, ellipsoid = masks(MATCH_BOX, MATCH_MASK_RADIUS)
    cases = [("spherical", TOMO_SHAPE, MATCH_BOX, sphere),
             ("ellipsoid", TOMO_SHAPE, MATCH_BOX, ellipsoid),
             ("spherical bin 4", RPC_SHAPE, RPC_BOX,
              masks(RPC_BOX, RPC_MASK_RADIUS)[0])]
    others = (MU.NAME, MU.NOISE_NAME, ZP.NAME, K.NAME, S.NAME, MS.NAME,
              MS.FINISH_NAME)
    rows = {}
    worst = [0.0, 0, 0]
    for name, shape, box, mask in cases:
        tomogram = torch.randn(shape, generator=gen, device=dev)
        template = torch.randn((box,) * 3, generator=gen, device=dev)
        ms = np.stack([transform_matrix(
            rotation=tuple(rng.uniform(-180, 180, 3)),
            rotation_order="rzxz", center=(box // 2,) * 3)
            for _ in range(MATCH_CALL)]).astype(np.float32)
        matcher = matching.TemplateMatcher(tomogram, template, mask,
                                           device=str(dev),
                                           random_phase_correction=True)
        del tomogram
        spherical = matcher.spherical
        assert spherical == (mask is not ellipsoid), name

        def call():
            matcher.reset()
            torch.cuda.synchronize()
            zero_launches()
            matcher.match(ms)
            torch.cuda.synchronize()
            return launch_counts()

        matcher.match(ms[:1])           # builds the kernels, plans FFTs
        counts = call()
        rotations = (2 if spherical else 3) * MATCH_CALL
        assert counts[MU.NOISE_NAME] == MATCH_CALL, (name, counts)
        assert counts[MU.NAME] == MATCH_CALL, (name, counts)
        # the sigma's two products take one launch
        assert counts[ZP.NAME] == (2 if spherical else 3) * MATCH_CALL, \
            (name, counts)
        assert counts[K.NAME] + counts[S.NAME] == rotations, (name, counts)
        # the sigma kernel's entries once an orientation under the ellipsoid
        sigma = 0 if spherical else MATCH_CALL
        assert counts[MS.NAME] == counts[MS.FINISH_NAME] == sigma, \
            (name, counts)
        assert all(v == 0 for k, v in counts.items() if k not in others), \
            (name, counts)
        kernel = (matcher.scores.clone(), matcher.indices.clone(),
                  matcher.noise.clone(), matcher.result("device")[0])
        assert not bool(torch.isnan(kernel[3]).any()), name
        # each orientation a call: the noise map against the plain update
        # of the map before it
        matcher.reset()
        for k, m in enumerate(ms):
            plain = matcher.noise.clone()
            matcher.match(m)
            inv = matcher._inv
            if not spherical:
                rotated = matcher._mask_sv.affine(m,
                                                  output=matcher._mask_box)
                inv = matcher._local_inv(rotated, rotated.sum())
            MU.plain_match_noise_update(matcher._correlation(), inv, plain)
            diff = score_diff(torch, (matcher.noise, matcher.indices),
                              (plain, matcher.indices))
            worst = [max(w, d) for w, d in zip(worst, diff)]
            assert diff == (0.0, 0, 0), (name, k, diff)
            del plain, inv
        # the same call with the entry's plain version
        entry = matching.match_noise_update
        matching.match_noise_update = MU.plain_match_noise_update
        try:
            moved = call()
        finally:
            matching.match_noise_update = entry
        assert moved[MU.NOISE_NAME] == 0, (name, moved)
        plain = (matcher.scores, matcher.indices, matcher.noise,
                 matcher.result("device")[0])
        against = {
            "maps": score_diff(torch, kernel[:2], plain[:2]),
            "noise": score_diff(torch, (kernel[2], kernel[1]),
                                (plain[2], kernel[1]))[:2],
            "corrected": score_diff(torch, (kernel[3], kernel[1]),
                                    (plain[3], kernel[1]))[:2]}
        assert all(not any(d) for d in against.values()), (name, against)
        unscored = int((kernel[1] < 0).sum())
        rows[name] = {"shape": list(shape), "box": box,
                      "launches": {k: counts[k] for k in others},
                      "kernel_against_plain": against,
                      "unscored_voxels": unscored}
        del matcher, kernel, plain
        torch.cuda.empty_cache()
    emit("matcher_rpc_launches", orientations=MATCH_CALL, cases=rows,
         max_abs_err=worst[0], max_bit_diff=worst[1],
         method="TemplateMatcher(random_phase_correction=True): one match "
         "call of the orientations from a reset, the counters set to 0 "
         "just before it (launches; A and B are the template's, the noise "
         "template's and, under the ellipsoid, the mask's rotations); then "
         "each orientation in a call of its own, the noise map after it "
         "against plain_match_noise_update of the map before it on the "
         "matcher's own noise correlation and 1/sigma (score_diff, the "
         "largest over the cases); kernel_against_plain: the call's maps "
         "against those of the same call on the same matcher with the "
         "entry's plain version (score_diff: 0 is bit for bit)")
    return {"launches": rows["spherical"]["launches"][MU.NOISE_NAME],
            "max_abs_err": worst[0], "max_bit_diff": worst[1],
            "cases": rows}


def match_zpass_phase(torch, np, dev):
    """Phase 4g: the spectral pass along z against its plain version at
    tm512's shapes, both dtypes; its device time alone beside its bound
    and the plain version's.  Then the same at MATCH_ODD_DEPTH, which the
    kernel's shared-memory design takes.  Returns the numbers for the
    kernels' line."""
    from voltools_tpu_torch.kernels import match_zpass as ZP
    from voltools_tpu_torch.models.matching import _spectral_layout
    gen = torch.Generator(device=dev).manual_seed(24)

    def at_depth(shape, box=MATCH_BOX):
        half = shape[2] // 2 + 1
        out = {"shape": list(shape), "box": box}
        for dtype in (torch.complex64, torch.complex128):
            # the planes laid out as the matcher's forward returns them
            planes = torch.randn((box, half, shape[1]), dtype=dtype,
                                 generator=gen, device=dev).permute(0, 2, 1)
            spectra = tuple(_spectral_layout(shape, dtype, dev).copy_(
                torch.randn((shape[0], shape[1], half), dtype=dtype,
                            generator=gen, device=dev))
                for _ in range(ZP.SPECTRA[dtype]))
            got = tuple(torch.empty_like(s) for s in spectra)
            want = tuple(torch.empty_like(s) for s in spectra)
            launches = launches_of(ZP.NAME)
            ZP.match_zpass(planes, spectra, got, box // 2)
            torch.cuda.synchronize()
            assert since(launches, ZP.NAME) == (1,)
            ZP.plain_match_zpass(planes, spectra, want, box // 2)
            err = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))
            # an FFT's rounding: a few units of the last place a level
            eps = torch.finfo(dtype.to_real()).eps
            assert err <= 10 * eps * math.log2(shape[0]), (dtype, err)
            size = planes.element_size()
            n_bytes = size * (planes.numel()
                              + 2 * len(spectra) * spectra[0].numel())
            kernel_ms = time_ms(torch, lambda: ZP.match_zpass(
                planes, spectra, got, box // 2), reps=20)
            plain_ms = time_ms(torch, lambda: ZP.plain_match_zpass(
                planes, spectra, want, box // 2), reps=5)
            name = str(dtype).split(".")[-1]
            out[name] = {"spectra": len(spectra), "max_rel_err": err,
                         "ms": kernel_ms, "plain_ms": plain_ms,
                         "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                         "bytes": n_bytes}
            del planes, spectra, got, want
            torch.cuda.empty_cache()
        return out

    out = at_depth(TOMO_SHAPE)
    odd = (MATCH_ODD_DEPTH,) + TOMO_SHAPE[1:]
    out[f"depth {MATCH_ODD_DEPTH}"] = at_depth(odd)
    out["bin 4"] = at_depth(RPC_SHAPE, RPC_BOX)
    emit("parity_match_zpass", shape=out["shape"], box=MATCH_BOX,
         max_rel_err={f"{k} depth {d['shape'][0]} width {d['shape'][2]} "
                      f"box {d['box']}": d[k]["max_rel_err"]
                      for d in (out, out[f"depth {MATCH_ODD_DEPTH}"],
                                out["bin 4"])
                      for k in ("complex64", "complex128")},
         method="the kernel against plain_match_zpass on the card: the "
         "largest |difference| over the largest |plain| of each result, at "
         "tm512's depth (the register design), at a depth that is not a "
         "power of two (the shared-memory design) and at tm1024-rpc's "
         "shape and box (the register design at depth 512, width 1024)")
    emit("match_zpass_times", **out,
         method="CUDA events around 20 back-to-back launches (the plain "
         "version 5), warm; bound_ms the planes and the spectra read once "
         "and the results written once at 3.35 TB/s")
    return out


def match_sigma_phase(torch, np, dev, zero_launches, launch_counts):
    """Phase 4h: the sigma kernel at tm512-nsmask's shapes -- a (256, 512,
    512) tomogram, a 48^3 box under the ellipsoid.  One orientation's
    moments (the spectral pass and torch's inverse along y, as
    ``TemplateMatcher._moments`` takes them) into the kernel and into its
    plain version: the largest |difference| over each voxel's plain value
    where neither is floored, and the voxels floored on one side only.
    Then one ``match`` call of MATCH_CALL orientations from a reset, the
    counters set to 0 just before it (each entry once an orientation), its
    maps against those of the same call with the plain version.  Then the
    device times.  Returns the numbers for the kernels' line."""
    from voltools_tpu_torch.kernels import match_sigma as MS
    from voltools_tpu_torch.models import matching
    from voltools_tpu_torch.models.matching import _irfft_yx
    from voltools_tpu_torch.utils import transform_matrix
    gen = torch.Generator(device=dev).manual_seed(28)
    rng = np.random.default_rng(28)
    box = MATCH_BOX
    g = torch.arange(box, dtype=torch.float32, device=dev) - box // 2
    axes = (g.view(-1, 1, 1), g.view(1, -1, 1), g.view(1, 1, -1))
    ellipsoid = (sum((a / s).square() for a, s in zip(
        axes, MATCH_SEMI_AXES)) <= 1.0).float()
    template = torch.randn((box,) * 3, generator=gen, device=dev)
    tomogram = torch.randn(TOMO_SHAPE, generator=gen, device=dev)
    ms = np.stack([transform_matrix(
        rotation=tuple(rng.uniform(-180, 180, 3)), rotation_order="rzxz",
        center=(box // 2,) * 3) for _ in range(MATCH_CALL)]
    ).astype(np.float32)
    matcher = matching.TemplateMatcher(tomogram, template, ellipsoid,
                                       device=str(dev))
    del tomogram
    width = TOMO_SHAPE[2]
    assert MS.design(width) == "registers"
    floor = matching.SIGMA_FLOOR ** 2
    rotated = matcher._mask_sv.affine(ms[0], output=matcher._mask_box)
    n = rotated.sum()
    mean, mean_sq = matcher._moments(rotated)
    got = MS.match_sigma(mean, mean_sq, n, width, floor)
    want = MS.plain_match_sigma(mean, mean_sq, n, width, floor)
    both = (got > 0) & (want > 0)
    err = float(((got - want).abs() / want)[both].max())
    one_side = int(((got == 0) != (want == 0)).sum())
    floored = int((want == 0).sum())
    del got, want, both
    # w's float64 rounding and rsqrt's last place: a few units of the last
    # place of each voxel's 1 / sqrt(w)
    assert err <= 8 * 2.0 ** -24 and one_side == 0, (err, one_side)

    def call(plain=False):
        kernel = MS.match_sigma
        if plain:
            MS.match_sigma = MS.plain_match_sigma
        try:
            matcher.reset()
            torch.cuda.synchronize()
            zero_launches()
            matcher.match(ms)
            torch.cuda.synchronize()
        finally:
            MS.match_sigma = kernel
        return launch_counts(), (matcher.scores.clone(),
                                 matcher.indices.clone())

    matcher.match(ms[:1])               # builds the kernels, plans FFTs
    counts, (a, ia) = call()
    assert counts[MS.NAME] == counts[MS.FINISH_NAME] == MATCH_CALL, counts
    moved, (b, ib) = call(plain=True)
    assert moved[MS.NAME] == moved[MS.FINISH_NAME] == 0, moved
    maps = {"max_rel_err": float((a - b).abs().max() / b.abs().max()),
            "indices_differ": int((ia != ib).sum())}
    assert maps["max_rel_err"] <= 1e-4, maps
    del a, b, ia, ib
    # the device times, the moments of one orientation
    out = torch.empty(TOMO_SHAPE, dtype=torch.float32, device=dev)
    largest = torch.empty(1, dtype=torch.int32, device=dev)
    sx_ms = time_ms(torch, lambda: MS._LAUNCH(
        dev, mean.data_ptr(), mean_sq.data_ptr(), *mean.stride(),
        *TOMO_SHAPE, n.data_ptr(), out.data_ptr(), largest.data_ptr(),
        None), reps=20)
    finish_ms = time_ms(torch, lambda: MS._FINISH(
        dev, out.data_ptr(), out.numel(), largest.data_ptr(), floor),
        reps=20)
    plain_ms = time_ms(torch, lambda: MS.plain_match_sigma(
        mean, mean_sq, n, width, floor), reps=5)
    del mean, mean_sq, out
    zpass_out = matcher._products(matcher._forward(matcher._wide),
                                  matcher._spectrum_wide,
                                  matcher._spectrum_sq_wide)

    def y_pass():
        return [torch.fft.ifft(t, dim=1, norm="forward") for t in zpass_out]

    def former_tail():
        # the matcher's tail before the kernel, as it queued it
        m, w = (_irfft_yx(t, TOMO_SHAPE) for t in zpass_out)
        w.mul_(math.prod(TOMO_SHAPE) * n.double()).addcmul_(
            m, m, value=-1.0)
        del m
        w = w.to(torch.float32)
        low = w <= floor * w.max().clamp_min(0.0)
        return w.rsqrt_().masked_fill_(low, 0.0)

    y_ms = time_ms(torch, y_pass, reps=5)
    tail_ms = time_ms(torch, former_tail, reps=5)
    new_tail_ms = time_ms(torch, lambda: MS.match_sigma(
        *y_pass(), n, width, floor), reps=5)
    del zpass_out, matcher
    torch.cuda.empty_cache()
    # the shared-memory design's widths (Stockham passes even and odd,
    # Bluestein's): moments whose w is a random positive map, from their
    # spectra along y and x
    other = {}
    for shape in ((64, 512, 480), (64, 512, 255), (32, 512, 2042)):
        sg = torch.Generator(device=dev).manual_seed(shape[2])
        weight = torch.tensor(137.25, dtype=torch.float32, device=dev)
        s = math.prod(shape) * float(weight)
        m = torch.randn(shape, dtype=torch.float64, generator=sg,
                        device=dev) * (0.3 * s)
        w = (torch.rand(shape, dtype=torch.float64, generator=sg,
                        device=dev) * 1.5 + 0.5) * (s * s)
        spectra = [torch.fft.ifft(matching._spectral_layout(
            shape, torch.complex128, dev).copy_(torch.fft.rfftn(
                r, dim=(1, 2), norm="forward")), dim=1, norm="forward")
            for r in (m, (w + m * m) / s)]
        del m, w
        got = MS.match_sigma(*spectra, weight, shape[2], floor)
        want = MS.plain_match_sigma(*spectra, weight, shape[2], floor)
        other[f"{shape[2]} {MS.design(shape[2])}"] = float(
            ((got - want).abs() / want).max())
        del spectra, got, want
        torch.cuda.empty_cache()
    assert all(e <= 8 * 2.0 ** -24 for e in other.values()), other
    half = TOMO_SHAPE[2] // 2 + 1
    read = 2 * TOMO_SHAPE[0] * TOMO_SHAPE[1] * half * 16
    written = math.prod(TOMO_SHAPE) * 4
    times = {"shape": list(TOMO_SHAPE), "ms": sx_ms,
             "bound_ms": (read + written) / HBM_BYTES_PER_S * 1e3,
             "bytes": read + written,
             "finish_ms": finish_ms,
             "finish_bound_ms": 2 * written / HBM_BYTES_PER_S * 1e3,
             "plain_ms": plain_ms, "y_pass_ms": y_ms,
             "tail_before_ms": tail_ms, "tail_after_ms": new_tail_ms}
    emit("parity_match_sigma", shape=list(TOMO_SHAPE), box=box,
         max_rel_err=err, floored_one_side=one_side, floored=floored,
         launches=counts[MS.NAME], finish_launches=counts[MS.FINISH_NAME],
         orientations=MATCH_CALL, maps_against_plain=maps,
         other_designs=other,
         method="one orientation's moments under tm512-nsmask's ellipsoid "
         "into match_sigma and plain_match_sigma on the card: max_rel_err "
         "the largest |difference| over the plain value where neither map "
         "is 0, floored_one_side the voxels 0 in one map only; then one "
         "TemplateMatcher.match call of the orientations from a reset, the "
         "counters set to 0 just before it, and maps_against_plain its "
         "scores' largest |difference| over their largest |score| and the "
         "indices that differ against the same call with the plain "
         "version; other_designs the largest |difference| over the plain "
         "value at widths of the shared-memory design (480 and 255 its "
         "Stockham passes, 2042 Bluestein's), moments of a random positive "
         "w")
    emit("match_sigma_times", **times,
         method="CUDA events around 20 back-to-back launches of each entry "
         "alone (the plain version and the tails 5 calls), warm, at one "
         "orientation's moments; bound_ms the two half-spectra read once "
         "and the float32 map written once at 3.35 TB/s, finish_bound_ms "
         "the map read and written once; y_pass_ms torch's two inverses "
         "along y; tail_before_ms the matcher's former tail from the "
         "spectral pass's outputs (torch's inverses along y and x and the "
         "plain passes), tail_after_ms the inverses along y and match_sigma")
    return {"max_rel_err": err, "floored_one_side": one_side,
            "maps": maps, "launches": counts[MS.NAME],
            "other_designs": other, **times}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1

    import numpy as np
    from scipy import ndimage

    import voltools_tpu_torch as vt
    from voltools_tpu_torch.kernels import _build
    from voltools_tpu_torch.kernels import affine_resample as K
    from voltools_tpu_torch.kernels import affine_slab as S
    from voltools_tpu_torch.kernels import backproject as BP
    from voltools_tpu_torch.kernels import match_sigma as MS
    from voltools_tpu_torch.kernels import match_update as MU
    from voltools_tpu_torch.kernels import match_zpass as ZP
    from voltools_tpu_torch.kernels import partial_sample as PS
    from voltools_tpu_torch.kernels import planner
    from voltools_tpu_torch.kernels.layout import pitched
    from voltools_tpu_torch.kernels.planner import (choose_plan, slab_plan,
                                                    walk_patch)
    from voltools_tpu_torch.models import (TiltSeriesProjector,
                                           sirt_reconstruct,
                                           wbp_reconstruct)
    from voltools_tpu_torch.models.projections import plain_project_stack
    from voltools_tpu_torch.ops.interpolation import spline_order
    from voltools_tpu_torch.ops.prefilter import bspline_prefilter
    from voltools_tpu_torch.ops.sampling import affine_sample
    from voltools_tpu_torch.utils import (transform_matrix,
                                          translation_matrix)

    walk = K.affine_resample
    slab = S.affine_slab
    bproj = BP.backproject
    d1 = PS.partial_sample
    d2 = PS.partial_project
    D1, D2 = "partial_sample", "partial_project"
    ABC = (S.NAME, K.NAME, BP.NAME)

    zero_launches = _build.reset_launches

    def launch_counts():
        """Launches per kernel, from the store's counts of whole launches
        (not those of a path, "<name>.<path>"); D1's are its two entries'
        together."""
        n = {k: v for k, v in _build.launches().items() if "." not in k}
        n[D1] += n.pop("partial_sample_ring")
        return n

    def entry_counts():
        """D1's launches by entry, D2's on the line path."""
        n = _build.launches()
        return {"d1_ring": n["partial_sample_ring"], "d1_step": n[D1],
                "d2_line": n["partial_project.line"]}

    def row_gather_against_baseline(projs, minv, shape, reps):
        """C's row-gather call (the wrapper: its pitched copy and launch)
        and the baseline kernel's launch on the same projections, timed in
        turns (C, baseline, baseline, C), each held bit for bit to the
        other; with C's tile, shared memory a CTA and registers."""
        coef = torch.from_numpy(BP.coefficients(minv, [1, 2], True)).to(dev)
        out = torch.empty(shape, device=dev)

        def baseline():
            code = baseline_backproject(
                projs.data_ptr(), *projs.shape, coef.data_ptr(), 2,
                out.data_ptr(), *shape,
                torch.cuda.current_stream().cuda_stream)
            assert code == 0, code

        baseline()
        assert torch.equal(out, bproj(projs, minv, [1, 2], shape, True))
        runs = {"c": [], "baseline": []}
        for name in ("c", "baseline", "baseline", "c"):
            fn = baseline if name == "baseline" else (
                lambda: bproj(projs, minv, [1, 2], shape, True))
            runs[name].append(time_ms(torch, fn, reps=reps))
        tile = BP.rowgather_tile(BP.coefficients(minv, [1, 2], True),
                                 shape[0], shape[1], projs.shape[1])
        # registers and spills as ptxas reported them in phase 2's build
        usage = _build.ptxas_usage(_build.BUILD_LOG.get(
            BP.NAME, (None, ""))[1], f"rowgather_kernelILi{tile.lines}E")
        regs, spill = usage or (None, None)
        return {"ms": sum(runs["c"]) / 2, "runs_ms": runs["c"],
                "baseline_ms": sum(runs["baseline"]) / 2,
                "baseline_runs_ms": runs["baseline"], "tile": list(tile),
                "smem_bytes": BP.smem_bytes(*tile), "registers": regs,
                "spill_store_bytes": spill}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    interp_of = {1: "linear", 3: "bspline"}

    def plan_of(ms, shape, order, mode="constant"):
        """The box rule's plan: B can take the launch."""
        return slab_plan(ms, shape, interp_of[order], mode)

    def routed(ms, shape, order):
        """The planner's plan: B takes the launch and is the faster."""
        return choose_plan(ms, shape, interp_of[order])

    def planned(launches, back_projections=0):
        """The planner's kernel for each resampling launch, given as
        (matrices, shape, order), and C's ``back_projections``."""
        counts = {S.NAME: 0, K.NAME: 0, BP.NAME: back_projections, D1: 0,
                  D2: 0, MU.NAME: 0, MU.NOISE_NAME: 0, ZP.NAME: 0,
                  MS.NAME: 0, MS.FINISH_NAME: 0}
        for ms, shape, order in launches:
            counts[S.NAME if routed(ms, shape, order) is not None
                   else K.NAME] += 1
        return counts

    def chunks_of(ms, shape):
        """A stack of matrices in the launches the projector and
        ``StaticVolume.affine_batch`` make of it."""
        chunk = vt.StaticVolume.batch_chunk(shape)
        return [ms[p:p + chunk] for p in range(0, len(ms), chunk)]

    # ---------------------------------------------------------- 1. card
    smi = card_line()
    print(smi, flush=True)
    CARD["card"] = smi
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit("card", torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         python=sys.version.split()[0], kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # --------------------------------------------------------- 2. build
    # one nvcc per source, all started together
    kernel_modules = (K, S, BP, PS, MU, ZP, MS)
    cached = {m.NAME: _build.library_path(
        m.NAME, m.LIBRARY.defines).is_file() for m in kernel_modules}

    def build_baseline(source, name):
        """A kernel before its redesign, timed beside it (C's in phase 7,
        D's in phase 10); nothing of the package builds or calls it."""
        lib = _build.BUILD_DIR / f"lib{name}.so"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t = time.perf_counter()
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           source)
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC_DIR), "-o", str(lib), src],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {source}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        return str(lib), time.perf_counter() - t, proc.stdout + proc.stderr

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernel_modules) + 2) as pool:
        baseline_build = pool.submit(build_baseline, BASELINE_SOURCE,
                                     "backproject_baseline")
        d_baseline_build = pool.submit(build_baseline, D_BASELINE_SOURCE,
                                       "partial_sample_baseline")
        list(pool.map(lambda m: _build.build(m.NAME, m.LIBRARY.defines),
                      kernel_modules))
        baseline_lib, baseline_seconds, baseline_log = baseline_build.result()
        d_baseline_lib, d_baseline_seconds, d_baseline_log = \
            d_baseline_build.result()
    for m in kernel_modules:
        m.LIBRARY.lib()
    wall = time.perf_counter() - t0
    for m in kernel_modules:
        seconds, log = _build.BUILD_LOG.get(m.NAME, (None, ""))
        emit("build", source=m.SOURCE, seconds=seconds,
             built_now=not cached[m.NAME], wall_seconds_all=wall,
             flags=" ".join(_build.flags(m.LIBRARY.defines)),
             ptxas=[ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln])
    for source, seconds, log in (
            (BASELINE_SOURCE, baseline_seconds, baseline_log),
            (D_BASELINE_SOURCE, d_baseline_seconds, d_baseline_log)):
        emit("build", source=source, seconds=seconds, built_now=True,
             wall_seconds_all=wall,
             ptxas=[ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln])
    baseline_backproject = ctypes.CDLL(
        baseline_lib).backproject_baseline_launch
    baseline_backproject.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    baseline_backproject.restype = ctypes.c_int
    d_baseline = ctypes.CDLL(d_baseline_lib)
    d_baseline.partial_sample_baseline_launch.argtypes = PS.SAMPLE_ARGTYPES
    d_baseline.partial_sample_baseline_launch.restype = ctypes.c_int
    # the baseline's D2 entry: the committed one's parameters without `line`
    d_baseline.partial_project_baseline_launch.argtypes = (
        PS.PROJECT_ARGTYPES[:11] + PS.PROJECT_ARGTYPES[12:])
    d_baseline.partial_project_baseline_launch.restype = ctypes.c_int

    # ------------------------------------------ 3. A vs its plain version
    rng = np.random.default_rng(1)
    worst = {1: 0.0, 3: 0.0}
    worst_all = 0.0
    # A's in-range voxels, and those on its fast path, per order
    path_totals = {1: [0, 0], 3: [0, 0]}
    shapes = [(SIZE,) * 3, PALLAS_SHAPE, (1, 64, 80), (37, 1, 29)]
    for shape in shapes:
        vol = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
        pvol = pitched(vol, copy=True)
        for set_name, ms in (
                ("random_set", matrix_set(np, transform_matrix, shape,
                                          seed=shape[0])),
                ("near_edge", near_edge_set(np, transform_matrix,
                                            translation_matrix, shape))):
            ms_dev = torch.from_numpy(ms).to(dev)
            patches = (K.FLAT_PATCH, K.DEEP_PATCH)
            in_range = {mode: sum(inside_voxels(torch, vt, shape, ms_dev,
                                                mode))
                        for mode in ("constant", "border")}
            for order in (1, 3):
                for mode in ("constant", "border"):
                    for cval in (0.0, 1.5):
                        errs = []
                        K.reset_fast_path_voxels(dev)
                        for i in range(len(ms)):
                            want = affine_sample(vol, ms_dev[i],
                                                 interp_of[order], mode,
                                                 cval, prefiltered=True)
                            # both warp patches, the contiguous and the
                            # pitched volume, bit for bit
                            for p in patches:
                                for v in (vol, pvol):
                                    got = walk(v, ms_dev[i], order, mode,
                                               cval, patch=p)
                                    assert torch.equal(got, want), (
                                        shape, set_name, order, mode, cval,
                                        i, p, v.stride(1), "A != plain")
                            off, every = errors(torch, got, want, ms[i])
                            errs.append(off)
                            worst[order] = max(worst[order], off)
                            worst_all = max(worst_all, every)
                            assert off <= ATOL, (shape, order, mode, cval, i,
                                                 off)
                        # the device's count over the 2 patches x 2
                        # layouts, against their in-range voxels
                        fast = K.fast_path_voxels(dev)
                        total = 4 * in_range[mode]
                        assert fast <= total, (shape, set_name, order, mode,
                                               fast, total)
                        assert order == 3 or fast == 0, (order, fast)
                        path_totals[order][0] += fast
                        path_totals[order][1] += total
                        emit("parity", kernel=K.NAME, set=set_name,
                             shape=list(shape), order=order, mode=mode,
                             cval=cval, pitch=pvol.stride(1),
                             patches=[list(p) for p in patches],
                             equal_on_pitched=True, equal_to_plain=True,
                             fast_path_voxels=fast, in_range_voxels=total,
                             fast_path_share=fast / max(total, 1),
                             max_abs_err=errs,
                             atol=ATOL)
    # both of A's cubic paths ran on the cases held against the plain
    # version, as the device counted them
    assert 0 < path_totals[3][0] < path_totals[3][1], path_totals
    emit("parity_paths", kernel=K.NAME, fast_path_and_in_range_voxels={
        "linear": path_totals[1], "cubic": path_totals[3]})

    vol = torch.from_numpy(rng.random((SIZE,) * 3).astype(np.float32)).to(dev)
    ms = np.stack([matrix_set(np, transform_matrix, (SIZE,) * 3, seed=s)[:2]
                   for s in range(8)]).reshape(-1, 4, 4)
    ms_dev = torch.from_numpy(ms).to(dev)
    for order in (1, 3):
        batch = walk(vol, ms_dev, order)
        errs = []
        for i in range(len(ms)):
            want = affine_sample(vol, ms_dev[i], interp_of[order],
                                 prefiltered=True)
            off, _ = errors(torch, batch[i], want, ms[i])
            errs.append(off)
            assert off <= ATOL, ("batch", order, i, off)
            assert torch.equal(batch[i], walk(vol, ms_dev[i], order)), \
                "a batched launch differs from a single one"
        buf = torch.full((SIZE,) * 3, float("nan"), device=dev)
        assert walk(vol, ms_dev[3], order, out=buf) is buf
        assert torch.equal(buf, batch[3]), "write into a preallocated tensor"
        torch.cuda.synchronize()
        emit("parity_batch", kernel=K.NAME, order=order, n=len(ms),
             max_abs_err=max(errs), into_buffer="ok", atol=ATOL)
    del vol, pvol, batch, buf

    # ------------------------------ 4. B vs its plain version and vs A
    slab_worst = {1: 0.0, 3: 0.0}
    slab_worst_all = 0.0
    big = (SIZE,) * 3
    sets = [("pallas_cases", PALLAS_SHAPE,
             pallas_cases(np, transform_matrix, translation_matrix,
                          PALLAS_CENTER))]
    sets += [(f"tilt_axis_{ax}", big,
              tilt_series(np, transform_matrix, big, ax)) for ax in range(3)]
    sets.append(("random_set", big, matrix_set(np, transform_matrix, big,
                                               seed=SIZE)))
    for shape in ((1, 64, 80), (37, 1, 29)):
        center = tuple((s - 1) / 2 for s in shape)
        sets.append((f"extent_1_{shape}", shape,
                     pallas_cases(np, transform_matrix, translation_matrix,
                                  center)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, shape, ms in sets:
        vol = pitched(torch.from_numpy(rng.random(shape).astype(
            np.float32)).to(dev))
        ms_dev = torch.from_numpy(ms).to(dev)
        for order in (1, 3):
            for mode in ("constant", "border"):
                # one launch for the set where its envelope fits, else one
                # launch per matrix
                envelope = plan_of(ms, shape, order, mode)
                plans = [envelope] if envelope is not None else [
                    plan_of(m, shape, order, mode) for m in ms]
                assert None not in plans, (name, order, mode, "no slab plan")
                blocks = min(S.blocks_per_sm(p, dev) for p in plans)
                for cval in (0.0, 1.5):
                    if envelope is not None:
                        got = slab(vol, ms_dev, order, mode, cval,
                                   plan=envelope)
                    else:
                        got = torch.stack([
                            slab(vol, ms_dev[i], order, mode, cval, plan=p)
                            for i, p in enumerate(plans)])
                    same = torch.equal(got, walk(vol, ms_dev, order, mode,
                                                 cval))
                    assert same, (name, order, mode, cval, "B != A")
                    errs = []
                    for i in range(len(ms)):
                        want = affine_sample(vol, ms_dev[i], interp_of[order],
                                             mode, cval, prefiltered=True)
                        off, every = errors(torch, got[i], want, ms[i])
                        errs.append(off)
                        slab_worst[order] = max(slab_worst[order], off)
                        slab_worst_all = max(slab_worst_all, every)
                        assert off <= ATOL, (name, order, mode, cval, i, off)
                    torch.cuda.synchronize()
                    emit("parity_slab", set=name, shape=list(shape),
                         pitch=vol.stride(1),
                         n=len(ms), order=order, mode=mode, cval=cval,
                         launches=len(plans),
                         extents=[list(p.extents) for p in plans],
                         box_per_voxel=[p.box_per_voxel for p in plans],
                         blocks_per_sm=blocks, grid=blocks * sms,
                         stages=planner.STAGES,
                         equal_to_walk=same, max_abs_err=max(errs),
                         atol=ATOL)
        del vol, got
    # a single matrix, and a write into a preallocated tensor
    vol = pitched(torch.from_numpy(rng.random(big).astype(np.float32)).to(
        dev))
    ms = tilt_series(np, transform_matrix, big, TILT_AXIS)
    ms_dev = torch.from_numpy(ms).to(dev)
    for order in (1, 3):
        plan = plan_of(ms[5], big, order)
        buf = torch.full(big, float("nan"), device=dev)
        assert slab(vol, ms_dev[5], order, out=buf, plan=plan) is buf
        assert torch.equal(buf, walk(vol, ms_dev[5], order)), "into buffer"
        assert torch.equal(buf, slab(vol, ms_dev, order,
                                     plan=plan_of(ms, big, order))[5]), \
            "a batched launch differs from a single one"
    overflows = S.overflows(dev)
    assert overflows == 0, ("slab overflows", overflows)
    emit("parity_slab_single", into_buffer="ok", batch_equals_single="ok",
         overflows=overflows)
    del vol, buf

    # ------------------ 4d. B's row path vs its general kernel, bit for bit
    rows_times = rows_phase(torch, np, dev)

    # ------------- 4e. template matching's update vs its plain version
    match_times = match_update_phase(torch, np, dev)
    noise_times = match_noise_update_phase(torch, np, dev)
    # ------------------ 4f. TemplateMatcher.match: the update's launches
    match_path = matcher_phase(torch, np, dev, zero_launches, launch_counts)
    rpc_path = matcher_rpc_phase(torch, np, dev, zero_launches,
                                 launch_counts)
    # ------------ 4g. the spectral pass along z vs its plain version
    zpass_times = match_zpass_phase(torch, np, dev)
    # ------------------- 4h. the sigma kernel vs its plain version
    sigma_times = match_sigma_phase(torch, np, dev, zero_launches,
                                    launch_counts)

    # --------------------------- 4b. C vs its plain version, bit for bit
    from voltools_tpu_torch.parallel.sharded import _shifted
    rng = np.random.default_rng(4)
    recon_series = tilt_series(np, transform_matrix, big, RECON_TILT_AXIS)
    odd = (37, 50, 61)
    odd_series = tilt_series(np, transform_matrix, odd, RECON_TILT_AXIS)
    # (name, output shape, projection axis, pull-back matrices, the path
    # the geometry takes, the paths run: the general path on a row-gather
    # geometry is _force_general's)
    both = ("rowgather", "general")
    bp_cases = [
        ("recon_series_axis0", big, 0, recon_series, "rowgather",
         ("rowgather",)),
        ("axis1", big, 1, axis_series(np, big, 2), "rowgather",
         ("rowgather",)),
        ("axis2", big, 2, axis_series(np, big, 1), "rowgather",
         ("rowgather",)),
        ("recon_series_forced_general", big, 0, recon_series, "rowgather",
         ("general",)),
        ("general_geometry", big, 0, axis_series(np, big, 1), "general",
         ("general",)),
        ("odd_shape", odd, 0, odd_series, "rowgather", both),
        ("one_tilt", big, 0, recon_series[20:21], "rowgather", both),
    ]
    bp_rows = []
    misses_before = BP.window_misses(dev)

    def c_tile(minv, keep, out_shape, proj_shape):
        """The row-gather tile the wrapper picks for this call."""
        dep1 = 1 if keep[1] == 2 else 2
        return list(BP.rowgather_tile(BP.coefficients(minv, keep, True),
                                      out_shape[0], out_shape[dep1],
                                      proj_shape[0]))

    def bp_check(name, projs, minv, keep, out_shape, rowgather):
        got = bproj(projs, minv, keep, out_shape, rowgather)
        want = BP.plain_backproject(projs, minv, keep, out_shape, rowgather)
        assert got.shape == out_shape and torch.isfinite(got).all(), name
        assert torch.equal(got, want), (name, rowgather, float(
            (got - want).abs().max()))
        return float((got - want).abs().max())

    for name, shape, axis, ms, geometry, paths in bp_cases:
        keep = [a for a in range(3) if a != axis]
        minv = inverses(np, ms)
        pshape = (shape[keep[0]], shape[keep[1]])
        projs = torch.from_numpy(rng.random((len(ms),) + pshape,
                                            dtype=np.float32)).to(dev)
        assert BP.row_gather(minv, keep, shape, pshape) == (
            geometry == "rowgather"), name
        for path in paths:
            err = bp_check(name, projs, minv, keep, shape,
                           path == "rowgather")
            bp_rows.append({"case": name, "shape": list(shape),
                            "projection_axis": axis, "tilts": len(ms),
                            "path": path, "max_abs_err": err,
                            "tile": c_tile(minv, keep, shape, pshape)
                            if path == "rowgather" else None})
    # a volume shard's calls: 4 slabs of 63 planes, the slab offset folded
    # into column 3 of M^-1, the path decided on the unshifted matrices
    minv = inverses(np, recon_series)
    projs = torch.from_numpy(rng.random((len(minv), SIZE, SIZE),
                                        dtype=np.float32)).to(dev)
    local = -(-SIZE // SHARDS)
    slab_shape = (local,) + big[1:]
    for path in ("rowgather", "general"):
        for i in range(SHARDS):
            mv = _shifted(minv, np.float32(i * local))
            err = bp_check("shifted", projs, mv, [1, 2], slab_shape,
                           path == "rowgather")
            bp_rows.append({"case": f"shifted_slab_{i}",
                            "shape": list(slab_shape), "projection_axis": 0,
                            "tilts": len(mv), "path": path,
                            "max_abs_err": err})
    # rows partly off the projection (each tilt shifted by up to half the
    # projection's height), one tilt far off (int32 would wrap at 1e10)
    off = minv.copy()
    off[:, 1, 3] += np.linspace(-0.5, 0.5, len(off),
                                dtype=np.float32) * SIZE
    off[0, 1, 3] = np.float32(1e10)
    off[1, 1, 3] = np.float32(-1e10)
    for path in ("rowgather", "general"):
        err = bp_check("rows_off", projs, off, [1, 2], big,
                       path == "rowgather")
        bp_rows.append({"case": "rows_off_the_projection",
                        "shape": list(big), "projection_axis": 0,
                        "tilts": len(off), "path": path, "max_abs_err": err})
    # a scaled row-gather matrix: its rows span more than the first tile's
    # window can hold in the shared memory, so the wrapper takes a smaller
    # tile, still on the row-gather kernel
    span = minv.copy()
    span[:, 1, :2] *= np.float32(LARGE_SPAN_SCALE)
    assert BP.row_gather(span, [1, 2], big, big[1:])
    span_tile = c_tile(span, [1, 2], big, big[1:])
    assert tuple(span_tile[:2]) != BP.TILES[0], span_tile
    err = bp_check("large_span", projs, span, [1, 2], big, True)
    bp_rows.append({"case": "large_span_scaled_rows", "shape": list(big),
                    "projection_axis": 0, "tilts": len(span),
                    "path": "rowgather", "max_abs_err": err,
                    "tile": span_tile})
    bp_worst = max(r["max_abs_err"] for r in bp_rows)
    torch.cuda.synchronize()
    bp_misses = BP.window_misses(dev) - misses_before
    assert bp_misses == 0, ("taps outside their window", bp_misses)
    emit("parity_backproject", kernel=BP.NAME, cases=bp_rows,
         equal_to_plain=True, max_abs_err=bp_worst,
         window_misses=bp_misses)
    del projs

    # ------------------ 4c. D against its plain version, on 4 shards
    from voltools_tpu_torch.parallel import Mesh, ShardedVolume
    mesh = Mesh([dev] * SHARDS)
    rng = np.random.default_rng(5)
    ps_rows = []
    for shape in (big, odd):
        vol = rng.random(shape, dtype=np.float32)
        ms = matrix_set(np, transform_matrix, shape, seed=shape[0])[:2]
        ms = np.concatenate([ms, near_edge_set(
            np, transform_matrix, translation_matrix, shape)[2:4]])
        for interp, (mode, cval) in ((i, mc) for i in ("linear", "bspline")
                                     for mc in (("constant", 0.0),
                                                ("border", 1.5))):
            sv = ShardedVolume(vol, interp, mesh=mesh, mode=mode, cval=cval)
            order = spline_order(interp)
            local = sv._local
            for name, m in zip(("random_0", "random_1", "half_voxel_shift",
                                "scale_past_the_edges"), ms):
                # the ring entry, one launch a shard, through the body
                names = ("partial_sample_ring", "partial_sample")
                before = launches_of(*names)
                got = sv._stream_body(m)
                assert since(before, *names) == (SHARDS, 0)
                want = sv._stream_body(m, plain=True)
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                    shape, interp, mode, name, err)
                assert all(torch.isfinite(g).all() for g in got)
                # the per-step entry, a launch a slab, chained over each
                # shard's ring from a zero accumulator
                step_err = 0.0
                for i in range(SHARDS):
                    m_dev = _shifted(m, np.float32(i * local))
                    acc = torch.zeros_like(want[i])
                    for k in range(SHARDS):
                        j = (i - k) % SHARDS
                        d1(sv.data[j], m_dev, j * local, shape, order, mode,
                           acc, k == SHARDS - 1, cval)
                    step_err = max(step_err,
                                   float((acc - want[i]).abs().max()))
                    assert torch.equal(acc, want[i]), (
                        shape, interp, mode, name, "per step", i, step_err)
                assert since(before, *names) == (SHARDS, SHARDS * SHARDS)
                ps_rows.append({"shape": list(shape), "local": local,
                                "pad": sv._pad, "order": order,
                                "mode": mode, "cval": cval, "matrix": name,
                                "max_abs_err": err,
                                "per_step_max_abs_err": step_err})
            del sv, got, want, acc
    d1_worst = max(r["max_abs_err"] for r in ps_rows)
    pp_rows = []
    pp_cases = [("recon_series_axis0", big, 0, recon_series),
                ("random_axis1", big, 1,
                 matrix_set(np, transform_matrix, big, seed=11)),
                ("random_axis2", big, 2,
                 matrix_set(np, transform_matrix, big, seed=12)),
                ("odd_shape_axis0", odd, 0, odd_series)]
    for name, shape, axis, ms in pp_cases:
        local = -(-shape[0] // SHARDS)
        vol = torch.zeros((local * SHARDS,) + shape[1:], device=dev)
        vol[:shape[0]] = torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)
        keep = [a for a in range(3) if a != axis]
        line = PS.line_axis(ms, axis) == keep[1]
        assert line == name.endswith("axis0"), (name, PS.line_axis(ms, axis))
        for i in range(SHARDS):
            x = vol[i * local:(i + 1) * local]
            off = float(np.float32(i * local))
            names = ("partial_project", "partial_project.line")
            before = launches_of(*names)
            got = d2(x, ms, off, shape, axis)
            assert since(before, *names) == (1, int(line))
            # the line path against the general kernel, bit for bit
            general = d2(x, ms, off, shape, axis, _force_general=True) \
                if line else got
            assert torch.equal(got, general), (
                name, i, float((got - general).abs().max()))
            want = PS.plain_partial_project(x, ms, off, shape, axis)
            largest = float(PS.plain_partial_project(x.abs(), ms, off, shape,
                                                     axis).max())
            err = max(float((got - want).abs().max()),
                      float((general - want).abs().max()))
            atol = PS.sum_order_atol(shape[axis], largest)
            assert torch.isfinite(got).all() and err <= atol, (name, i, err,
                                                               atol)
            pp_rows.append({"case": name, "shape": list(shape),
                            "projection_axis": axis, "tilts": len(ms),
                            "shard": i,
                            "path": "line" if line else "general",
                            "line_equal_to_general": True if line else None,
                            "max_abs_err": err, "atol": atol,
                            "equal_to_plain": bool(torch.equal(got, want))})
        del vol, x, got, general, want
    d2_worst = max(r["max_abs_err"] for r in pp_rows)
    emit("parity_partial_sample", kernels=[D1, D2], shards=SHARDS,
         d1_cases=ps_rows, d1_equal_to_plain=True,
         d1_entries_equal_to_plain=["ring", "per_step"],
         d1_max_abs_err=d1_worst,
         d2_cases=pp_rows, d2_max_abs_err=d2_worst,
         d2_tolerance="2 (n_p - 1) 2**-24 x the largest plain partial "
         "projection of the slab's magnitudes: two orders of a float32 sum "
         "of the same n_p per-plane samples")

    # ---------------------------------------------------- 5. main path
    rng = np.random.default_rng(0)   # bench.py's volume and rotation stream
    vol_np = rng.random(big, dtype=np.float64).astype(np.float32)
    center = (SIZE / 2,) * 3
    rots = np.stack([transform_matrix(rotation=tuple(rng.uniform(-180, 180,
                                                                   3)),
                                      rotation_order="sxyz", center=center)
                     for _ in range(N_ROT)]).astype(np.float32)
    # what the planner gives for each launch of the main path: 16 single
    # calls and one batch (16 volumes of output fit one chunk) per volume,
    # the host-return call, the write into a preallocated tensor and the
    # one-shot call
    calls = ([rots[i] for i in range(N_ROT)] + [rots]) * 2 + [
        rots[0], rots[1], rots[0]]
    orders = [1] * (N_ROT + 1) + [3] * (N_ROT + 1) + [1, 3, 3]
    expected = planned([(m, big, order) for m, order in zip(calls, orders)])

    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    sv_lin = vt.StaticVolume(vol_np, "linear", device="cuda")
    lin = [sv_lin.affine(m, output="device") for m in rots]
    lin_batch = sv_lin.affine_batch(rots, output="device")
    sv_cub = vt.StaticVolume(vol_np, "filt_bspline", device="cuda")
    cub = [sv_cub.affine(m, output="device") for m in rots]
    cub_batch = sv_cub.affine_batch(rots, output="device")
    host = sv_lin.affine(rots[0])
    into = torch.empty(big, device=dev)
    into_ret = sv_cub.affine(rots[1], output=into)
    oneshot = vt.affine(vol_np, rots[0], interpolation="filt_bspline",
                        device="cuda", output="device")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    main_launches = launch_counts()
    assert main_launches == expected, (main_launches, expected)
    assert sum(main_launches.values()) == len(calls), main_launches
    assert vt.last_dispatch()["impl"] == "cuda"
    assert sv_lin.data.stride(1) % 4 == 0 and sv_cub.data.stride(1) % 4 == 0

    main_err = {1: 0.0, 3: 0.0}
    for order, sv, outs, batch in ((1, sv_lin, lin, lin_batch),
                                   (3, sv_cub, cub, cub_batch)):
        assert batch.shape == (N_ROT,) + big
        for i, m in enumerate(rots):
            assert outs[i].shape == big
            want = affine_sample(sv.data, torch.from_numpy(m).to(dev),
                                 interp_of[order], prefiltered=True)
            off, _ = errors(torch, outs[i], want, m)
            main_err[order] = max(main_err[order], off)
            assert off <= ATOL, ("main", order, i, off)
            assert torch.equal(batch[i], outs[i]), "affine_batch != affine"
    assert isinstance(host, np.ndarray) and host.dtype == np.float32
    assert np.array_equal(host, lin[0].cpu().numpy())
    assert into_ret is into and torch.equal(into, cub[1])
    off_one, _ = errors(torch, oneshot, cub[0], rots[0])
    assert off_one <= ATOL, ("one-shot", off_one)

    # scipy.ndimage oracles on one rotation, on the host in float64
    oracle = {}
    for order, got in ((1, host), (3, cub[0].cpu().numpy())):
        want = ndimage.affine_transform(vol_np.astype(np.float64),
                                        rots[0].astype(np.float64),
                                        order=order, prefilter=True,
                                        mode="constant", cval=0.0)
        off, every = errors(torch, torch.from_numpy(got),
                            torch.from_numpy(want), rots[0])
        oracle[order] = (off, every)
        assert off <= SCIPY_ATOL, ("scipy oracle", order, off)
    emit("main", shape=list(big), rotations=N_ROT, seconds=seconds,
         launches=main_launches, expected_launches=expected,
         max_abs_err_vs_plain={"linear": main_err[1], "cubic": main_err[3],
                               "one_shot": off_one},
         scipy_oracle={"linear": oracle[1][0], "cubic": oracle[3][0],
                       "linear_all_voxels": oracle[1][1],
                       "cubic_all_voxels": oracle[3][1],
                       "atol": SCIPY_ATOL})
    del lin, cub, lin_batch, cub_batch, oneshot

    # ------------------------------------------------- 6. tilt path
    angles = np.arange(*TILTS)
    tms = tilt_series(np, transform_matrix, big, TILT_AXIS)
    rms = tilt_series(np, transform_matrix, big, RECON_TILT_AXIS)
    # the projector's series in both orders, the reconstruction's series
    # once, then SIRT: the row sums and one forward sweep per iteration;
    # C: one back-projection per WBP, SIRT's column sums and one per
    # iteration
    expected_tilt = planned(
        [(c, big, order)
         for ms, order, times in ((tms, 1, 1), (tms, 3, 1),
                                  (rms, 1, 2 + SIRT_ITERATIONS))
         for c in chunks_of(ms, big) for _ in range(times)],
        back_projections=1 + 1 + SIRT_ITERATIONS)

    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    proj = {}
    projs = {}
    for interp in ("linear", "filt_bspline"):
        proj[interp] = TiltSeriesProjector(vol_np, interp, device="cuda")
        projs[interp] = proj[interp].project(angles, tilt_axis=TILT_AXIS,
                                             output="device")
    assert np.array_equal(proj["linear"].tilt_matrices(angles, TILT_AXIS),
                          tms)
    assert np.array_equal(
        proj["linear"].tilt_matrices(angles, RECON_TILT_AXIS), rms)
    rprojs = proj["linear"].project(angles, tilt_axis=RECON_TILT_AXIS,
                                    output="device")
    wbp = wbp_reconstruct(rprojs, rms, big, device="cuda", output="device")
    sirt = sirt_reconstruct(rprojs, rms, big, iterations=SIRT_ITERATIONS,
                            device="cuda", output="device")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tilt_launches = launch_counts()
    assert tilt_launches == expected_tilt, (tilt_launches, expected_tilt)
    # every kernel runs on one of the two paths at least
    assert all(main_launches[k] + tilt_launches[k] > 0
               for k in ABC), (main_launches, tilt_launches)

    proj_err = {}
    plain_projs = {}
    for name, interp, ms, got in (
            ("linear", "linear", tms, projs["linear"]),
            ("filt_bspline", "filt_bspline", tms, projs["filt_bspline"]),
            ("reconstruction_series", "linear", rms, rprojs)):
        assert got.shape == (len(ms), SIZE, SIZE)
        assert torch.isfinite(got).all()
        plain_projs[name] = plain_project_stack(
            proj[interp].data, ms, interp, "constant", 0)
        proj_err[name] = float((got - plain_projs[name]).abs().max())
        assert proj_err[name] <= PROJ_ATOL, (name, proj_err[name])
    # scipy on the first tilt: columns holding a knife-edge voxel are left
    # out, as in tests/test_models.py
    scipy_err = {}
    for interp, order in (("linear", 1), ("filt_bspline", 3)):
        want = ndimage.affine_transform(
            vol_np.astype(np.float64), tms[0].astype(np.float64),
            order=order, prefilter=True, mode="constant",
            cval=0.0).sum(axis=0)
        near = knife_mask(torch, tms[0], big, torch.device("cpu")).any(dim=0)
        diff = np.abs(projs[interp][0].cpu().numpy().astype(np.float64)
                      - want)
        scipy_err[interp] = float(np.where(near.numpy(), 0.0, diff).max())
        assert scipy_err[interp] <= PROJ_SCIPY_ATOL, (interp,
                                                      scipy_err[interp])
    rplain = plain_projs["reconstruction_series"]
    wbp_plain = wbp_reconstruct(rplain, rms, big, device="cuda",
                                output="device", _plain_adjoint=True)
    sirt_few, sirt_plain = (sirt_reconstruct(
        src, rms, big, iterations=SIRT_REFERENCE_ITERATIONS, device="cuda",
        output="device", _plain_forward=plain, _plain_adjoint=plain)
        for src, plain in ((rprojs, False), (rplain, True)))
    # where only C differs from its plain version, bit for bit: WBP of the
    # same projections, and the path's SIRT with the same (B's) forward
    only_c = {}
    for name, got, ref in (
            ("wbp", wbp, lambda: wbp_reconstruct(
                rprojs, rms, big, device="cuda", output="device",
                _plain_adjoint=True)),
            (f"sirt_{SIRT_ITERATIONS}_iterations", sirt,
             lambda: sirt_reconstruct(
                 rprojs, rms, big, iterations=SIRT_ITERATIONS,
                 device="cuda", output="device", _plain_adjoint=True))):
        only_c[name] = bool(torch.equal(got, ref()))
        assert only_c[name], (name, "with C != with its plain version")
    recon_err = {}
    corr = {}
    inner = (slice(SIZE // 10, -(SIZE // 10)),) * 3
    for name, got, want in (("wbp", wbp, wbp_plain),
                            (f"sirt_{SIRT_REFERENCE_ITERATIONS}_iterations",
                             sirt_few, sirt_plain)):
        assert torch.isfinite(got).all()
        scale = float(want.abs().max())
        recon_err[name] = float((got - want).abs().max()) / scale
        assert recon_err[name] <= RECON_RTOL, (name, recon_err[name])
    for name, got in (("wbp", wbp), ("sirt", sirt)):
        assert got.shape == big and torch.isfinite(got).all()
        # how much of the (white-noise) volume a +-60 degree series
        # recovers, away from the edges; reported, not checked
        corr[name] = float(np.corrcoef(got[inner].cpu().numpy().ravel(),
                                       vol_np[inner].ravel())[0, 1])
    assert S.overflows(dev) == 0
    first = chunks_of(tms, big)[0]
    emit("tilt", shape=list(big), tilts=len(tms), tilt_axis=TILT_AXIS,
         reconstruction_tilt_axis=RECON_TILT_AXIS,
         chunks=[len(c) for c in chunks_of(tms, big)], seconds=seconds,
         launches=tilt_launches, expected_launches=expected_tilt,
         extents={"linear": list(plan_of(first, big, 1).extents),
                  "cubic": list(plan_of(first, big, 3).extents),
                  "reconstruction": list(
                      plan_of(chunks_of(rms, big)[0], big, 1).extents)},
         max_abs_err_vs_plain=proj_err, proj_atol=PROJ_ATOL,
         scipy_first_tilt=scipy_err, scipy_atol=PROJ_SCIPY_ATOL,
         recon_rel_err_vs_plain_forward_and_adjoint=recon_err,
         recon_rtol=RECON_RTOL, equal_to_plain_adjoint=only_c,
         interior_correlation_with_volume=corr,
         sirt_iterations=SIRT_ITERATIONS, overflows=S.overflows(dev))
    del wbp, sirt, wbp_plain, sirt_few, sirt_plain, plain_projs, rplain

    # --------------------------------------------------------- 7. times
    coef = {1: sv_lin.data, 3: sv_cub.data}
    out = torch.empty(big, device=dev)
    stack = torch.empty((len(tms),) + big, device=dev)
    t = {}
    choices = {}
    # the projector's tilt series, the reconstruction's and bench.py's
    # rotations
    sets = {"tilt": tms, "recon_tilt": rms, "random": rots}
    for set_name, ms in sets.items():
        ms_dev = torch.from_numpy(ms).to(dev)
        inside = inside_voxels(torch, vt, big, ms_dev)
        t[f"{set_name}_inside_fraction"] = sum(inside) / (len(inside)
                                                          * SIZE ** 3)
        for order, name in ((1, "linear"), (3, "cubic")):
            plans = [plan_of(m, big, order) for m in ms]
            # A's warp patch for each matrix, as the planner picks it
            patches = [walk_patch(m) for m in ms]
            fit = [i for i, p in enumerate(plans) if p is not None]
            route = [routed(m, big, order) for m in ms]
            state = {"i": 0}

            def one_slab():
                i = fit[state["i"] % len(fit)]
                slab(coef[order], ms_dev[i], order, out=out, plan=plans[i])
                state["i"] += 1

            def one_walk():
                i = fit[state["i"] % len(fit)]
                walk(coef[order], ms_dev[i], order, out=out,
                     patch=patches[i])
                state["i"] += 1

            def every_walk():
                i = state["i"] % len(ms)
                walk(coef[order], ms_dev[i], order, out=out,
                     patch=patches[i])
                state["i"] += 1

            def as_routed():
                # each matrix on the kernel the planner routes it to
                i = state["i"] % len(ms)
                if route[i] is not None:
                    slab(coef[order], ms_dev[i], order, out=out,
                         plan=route[i])
                else:
                    walk(coef[order], ms_dev[i], order, out=out,
                         patch=patches[i])
                state["i"] += 1

            def box_rule_only():
                # the box rule alone: B wherever its box fits
                i = state["i"] % len(ms)
                if plans[i] is not None:
                    slab(coef[order], ms_dev[i], order, out=out,
                         plan=plans[i])
                else:
                    walk(coef[order], ms_dev[i], order, out=out,
                         patch=patches[i])
                state["i"] += 1

            key = f"{set_name}_{name}"
            # A's interior fast path on this set, one launch a matrix, as
            # the device counted it
            K.reset_fast_path_voxels(dev)
            for _ in ms:
                every_walk()
            fast = K.fast_path_voxels(dev)
            assert fast <= sum(inside) and (order == 3 or fast == 0), (
                key, fast)
            t[f"{key}_walk_fast_path_share"] = fast / sum(inside)
            t[f"{key}_walk_deep_patch_matrices"] = sum(
                p == K.DEEP_PATCH for p in patches)
            t[f"{key}_on_slab"] = len(fit)
            t[f"{key}_routed_to_slab"] = sum(p is not None for p in route)
            t[f"{key}_box_per_voxel"] = [p.box_per_voxel for p in plans
                                         if p is not None]
            # A on every matrix of the set, beside its bound
            t[f"{key}_walk_ms"] = time_ms(torch, every_walk,
                                          reps=2 * len(ms))
            t[f"{key}_walk_bound_ms"], t[f"{key}_walk_bound_by"] = bound_ms(
                order, big, big, inside, per_launch=1)
            # single launches of both kernels over the matrices B takes
            t[f"{key}_slab_ms"] = time_ms(torch, one_slab, reps=2 * len(fit))
            t[f"{key}_walk_same_ms"] = time_ms(torch, one_walk,
                                               reps=2 * len(fit))
            t[f"{key}_routed_ms"] = time_ms(torch, as_routed,
                                            reps=2 * len(ms))
            t[f"{key}_box_rule_only_ms"] = time_ms(torch, box_rule_only,
                                                   reps=2 * len(ms))
            fastest = min(t[f"{key}_walk_ms"], t[f"{key}_box_rule_only_ms"])
            n_slab = t[f"{key}_routed_to_slab"]
            choices[key] = {
                "planner": ("slab" if n_slab == len(ms) else
                            "walk" if n_slab == 0 else
                            f"slab {n_slab} of {len(ms)}"),
                "walk_ms": t[f"{key}_walk_ms"],
                "slab_ms": t[f"{key}_slab_ms"],
                "routed_ms": t[f"{key}_routed_ms"],
                "planner_within_5pct_of_faster":
                    t[f"{key}_routed_ms"] <= 1.05 * fastest}
            # the same set as the path launches it (the tilt series in
            # chunks, the random set in one launch): A alone, B alone where
            # every chunk's box fits, and each chunk on the kernel the
            # planner routes it to
            groups = [(torch.from_numpy(c).to(dev), plan_of(c, big, order),
                       routed(c, big, order), walk_patch(c))
                      for c in chunks_of(ms, big)]

            def batched(kind):
                for c_dev, plan, route_plan, patch in groups:
                    dst = stack[:len(c_dev)]
                    if kind == "slab" or kind == "routed" and route_plan:
                        slab(coef[order], c_dev, order, out=dst,
                             plan=plan if kind == "slab" else route_plan)
                    else:
                        walk(coef[order], c_dev, order, out=dst,
                             patch=patch)

            by_kind = {kind: time_ms(torch, lambda: batched(kind), reps=3)
                       / len(ms) for kind in ("walk", "routed")}
            by_kind["slab"] = None if any(
                g[1] is None for g in groups) else time_ms(
                    torch, lambda: batched("slab"), reps=3) / len(ms)
            n_slab = sum(g[2] is not None for g in groups)
            choices[f"{key}_batched"] = {
                "chunks": [len(g[0]) for g in groups],
                "planner": ("slab" if n_slab == len(groups) else
                            "walk" if n_slab == 0 else
                            f"slab {n_slab} of {len(groups)}"),
                "box_per_voxel": [g[1] and g[1].box_per_voxel
                                  for g in groups],
                "walk_ms": by_kind["walk"], "slab_ms": by_kind["slab"],
                "routed_ms": by_kind["routed"],
                "planner_within_5pct_of_faster": by_kind["routed"] <= 1.05
                * min(v for v in by_kind.values() if v is not None)}
            fit_in = [inside[i] for i in fit]
            t[f"{key}_bound_ms"], t[f"{key}_bound_by"] = bound_ms(
                order, big, big, fit_in, per_launch=1)
            # one launch of the whole set
            envelope = plan_of(ms, big, order)
            dst = stack[:len(ms)]
            t[f"{key}_batch_walk_ms_per_matrix"] = time_ms(
                torch, lambda: walk(coef[order], ms_dev, order, out=dst,
                                    patch=walk_patch(ms)),
                reps=3) / len(ms)
            t[f"{key}_batch_slab_ms_per_matrix"] = None if envelope is None \
                else time_ms(torch, lambda: slab(coef[order], ms_dev, order,
                                                 out=dst, plan=envelope),
                             reps=3) / len(ms)
            t[f"{key}_batch_bound_ms_per_matrix"], t[
                f"{key}_batch_bound_by"] = bound_ms(order, big, big, inside,
                                                    per_launch=len(ms))
            if envelope is not None:
                t[f"{key}_batch_blocks_per_sm"] = S.blocks_per_sm(envelope,
                                                                  dev)
                t[f"{key}_batch_box_per_voxel"] = envelope.box_per_voxel
            t[f"{key}_blocks_per_sm"] = sorted({
                S.blocks_per_sm(plans[i], dev) for i in fit})
            t[f"{key}_plain_ms"] = time_ms(
                torch, lambda: affine_sample(coef[order], ms_dev[fit[0]],
                                             interp_of[order],
                                             prefiltered=True),
                reps=3, warmup=1)
        # library yardstick: one trilinear grid_sample of the same
        # coordinates (align_corners=True maps -1..1 onto voxel centres
        # 0..n-1); timed only, the grid is built outside the timed region
        coords = vt.ops.affine_coords(big, ms_dev[0])
        grid = torch.stack([2.0 * coords[2 - a] / (SIZE - 1) - 1.0
                            for a in range(3)], dim=-1)[None]
        src = coef[1][None, None]
        t[f"{set_name}_grid_sample_trilinear_ms"] = time_ms(
            torch, lambda: torch.nn.functional.grid_sample(
                src, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True), reps=20)
        del coords, grid
    del stack
    # the speed rule's data: A and B one matrix at a time on both tilt
    # series and the random set, beside B's box voxels per output voxel
    # (matrices whose box fits B)
    sweep = {}
    for set_name, ms in (("tilt_axis_1", tms), ("tilt_axis_0", rms),
                         ("random", rots)):
        ms_dev = torch.from_numpy(ms).to(dev)
        for order, name in ((1, "linear"), (3, "cubic")):
            rows = []
            for i, m in enumerate(ms):
                plan = plan_of(m, big, order)
                if plan is None:
                    continue
                patch = walk_patch(m)
                a = time_ms(torch, lambda: walk(
                    coef[order], ms_dev[i], order, out=out, patch=patch),
                    reps=5)
                b = time_ms(torch, lambda: slab(
                    coef[order], ms_dev[i], order, out=out, plan=plan),
                    reps=5)
                rows.append([plan.box_per_voxel, a, b])
            sweep[f"{set_name}_{name}"] = sorted(rows)
    emit("speed_rule_sweep", columns=["box_per_voxel", "walk_ms", "slab_ms"],
         sets=sweep)
    emit("planner_choice", rule={
        # an order the slab kernel never takes reads null
        "slab_window": {str(k): v and v._asdict()
                        for k, v in planner.SLAB_WINDOW.items()},
        "smem_budget": planner.SMEM_BUDGET, "stages": planner.STAGES,
        "brick": {str(k): list(v) for k, v in planner.BRICK.items()}},
         sets=choices)
    # the planner's host work per call, as StaticVolume.affine makes it:
    # route (the box and speed rules) and walk_patch on one rotation
    reps = 2000
    for order, name in ((1, "linear"), (3, "cubic")):
        t0 = time.perf_counter()
        for i in range(reps):
            planner.route(rots[i % N_ROT], big, interp_of[order])
        t[f"planner_route_{name}_us"] = (time.perf_counter() - t0) / reps * 1e6
    t0 = time.perf_counter()
    for i in range(reps):
        walk_patch(rots[i % N_ROT])
    t["walk_patch_us"] = (time.perf_counter() - t0) / reps * 1e6
    # the main path's end-to-end metric: StaticVolume.affine per rotation,
    # through the planner
    for order, name, sv in ((1, "linear", sv_lin), (3, "cubic", sv_cub)):
        state = {"i": 0}

        def api():
            sv.affine(rots[state["i"] % N_ROT], output=out)
            state["i"] += 1

        t[f"static_volume_affine_{name}_ms"] = time_ms(torch, api,
                                                       reps=3 * N_ROT)
    for interp in ("linear", "filt_bspline"):
        t[f"projector_{interp}_ms_per_tilt"] = time_ms(
            torch, lambda: proj[interp].project(
                angles, tilt_axis=TILT_AXIS, output="device"),
            reps=3, warmup=1) / len(tms)
    t["wbp_ms"] = time_ms(torch, lambda: wbp_reconstruct(
        rprojs, rms, big, device="cuda", output="device"), reps=3, warmup=1)
    sirt_1 = time_ms(torch, lambda: sirt_reconstruct(
        rprojs, rms, big, iterations=1, device="cuda", output="device"),
        reps=2, warmup=1)
    sirt_4 = time_ms(torch, lambda: sirt_reconstruct(
        rprojs, rms, big, iterations=4, device="cuda", output="device"),
        reps=2, warmup=1)
    t["sirt_ms_per_iteration"] = (sirt_4 - sirt_1) / 3
    t["sirt_setup_ms"] = sirt_1 - t["sirt_ms_per_iteration"]
    # the same two with C's plain version, in the same call
    t["wbp_plain_adjoint_ms"] = time_ms(torch, lambda: wbp_reconstruct(
        rprojs, rms, big, device="cuda", output="device",
        _plain_adjoint=True), reps=3, warmup=1)
    sirt_p = [time_ms(torch, lambda n=n: sirt_reconstruct(
        rprojs, rms, big, iterations=n, device="cuda", output="device",
        _plain_adjoint=True), reps=2, warmup=1) for n in (1, 4)]
    t["sirt_plain_adjoint_ms_per_iteration"] = (sirt_p[1] - sirt_p[0]) / 3
    # C alone on the reconstruction's series (41 projections of 250^2) on
    # both paths, its plain version, its bound and a library yardstick
    rminv = inverses(np, rms)
    misses_before = BP.window_misses(dev)
    t["backproject_general_ms"] = time_ms(torch, lambda: bproj(
        rprojs, rminv, [1, 2], big, False), reps=20)
    for path in ("rowgather", "general"):
        rowgather = path == "rowgather"
        key = f"backproject_{path}"
        t[f"{key}_plain_ms"] = time_ms(torch, lambda: BP.plain_backproject(
            rprojs, rminv, [1, 2], big, rowgather), reps=3, warmup=1)
        t[f"{key}_bound_ms"], t[f"{key}_bound_by"] = backproject_bound_ms(
            len(rms), big, big[1:], rowgather)
    # the row-gather path beside C's row-gather kernel before its redesign
    # (tools/backproject_baseline.cu) on the same inputs, in turns: C,
    # baseline, baseline, C; its tile, shared memory a CTA and registers;
    # the floor of a design that keeps bit parity (no contraction)
    rowgather_c = row_gather_against_baseline(
        rprojs, rminv, big, reps=20)
    t.update({f"backproject_rowgather_{k}": v
              for k, v in rowgather_c.items()})
    t["backproject_rowgather_floor_ms"] = backproject_floor_ms(len(rms), big)
    # the host's waits on the device in one call of C, and of WBP, less
    # those of a call that only fills one float: C waits on nothing
    base_syncs = host_syncs(torch, lambda: torch.zeros(1, device=dev))
    t["backproject_host_syncs"] = host_syncs(torch, lambda: bproj(
        rprojs, rminv, [1, 2], big, True)) - base_syncs
    assert t["backproject_host_syncs"] == 0, t["backproject_host_syncs"]
    t["wbp_host_syncs"] = host_syncs(torch, lambda: wbp_reconstruct(
        rprojs, rms, big, device="cuda", output="device")) - base_syncs
    # one grid_sample of the 41 projections at every voxel's (rows, cols)
    # (align_corners=True maps -1..1 onto pixel centres 0..n-1, 'zeros'
    # counts each tap off the projection 0), then the sum over the tilts;
    # timed only, the grid is built outside the timed region
    table = torch.from_numpy(BP.coefficients(rminv, [1, 2], True)).to(dev)
    zz = torch.arange(SIZE, dtype=torch.float32, device=dev).view(1, -1, 1)
    yy = torch.arange(SIZE, dtype=torch.float32, device=dev).view(1, 1, -1)
    rows = ((table[:, 0].view(-1, 1, 1) * zz + table[:, 1].view(-1, 1, 1)
             * yy) + table[:, 2].view(-1, 1, 1)).reshape(len(rms), -1, 1)
    grid = torch.empty((len(rms), SIZE * SIZE, SIZE, 2), device=dev)
    grid[..., 0] = 2.0 * torch.arange(SIZE, dtype=torch.float32,
                                      device=dev) / (SIZE - 1) - 1.0
    grid[..., 1] = 2.0 * rows / (SIZE - 1) - 1.0
    del rows
    src = rprojs[:, None]

    def library_backproject():
        return torch.nn.functional.grid_sample(
            src, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True).sum(0).view(big)

    t["backproject_grid_sample_sum_ms"] = time_ms(
        torch, library_backproject, reps=3, warmup=1)
    t["backproject_grid_sample_sum_max_abs_diff"] = float(
        (library_backproject() - bproj(rprojs, rminv, [1, 2], big, True))
        .abs().max())
    del grid, src
    # WBP at a tomogram's size: (256, 512, 512) from 41 projections of
    # (512, 512), C against its plain version, bit for bit
    tomo_ms = tilt_series(np, transform_matrix, TOMO_SHAPE, RECON_TILT_AXIS)
    tomo_projs = torch.from_numpy(np.random.default_rng(5).random(
        (len(tomo_ms),) + TOMO_SHAPE[1:], dtype=np.float32)).to(dev)
    tomo = {plain: wbp_reconstruct(tomo_projs, tomo_ms, TOMO_SHAPE,
                                   device="cuda", output="device",
                                   _plain_adjoint=plain)
            for plain in (False, True)}
    assert tomo[False].shape == TOMO_SHAPE
    assert torch.isfinite(tomo[False]).all()
    assert torch.equal(tomo[False], tomo[True]), "tomogram WBP: C != plain"
    del tomo
    t["tomogram_shape"] = list(TOMO_SHAPE)
    for plain, key in ((False, "tomogram_wbp_ms"),
                       (True, "tomogram_wbp_plain_adjoint_ms")):
        t[key] = time_ms(torch, lambda: wbp_reconstruct(
            tomo_projs, tomo_ms, TOMO_SHAPE, device="cuda", output="device",
            _plain_adjoint=plain), reps=2, warmup=1)
    tomo_minv = inverses(np, tomo_ms)
    tomogram_c = row_gather_against_baseline(
        tomo_projs, tomo_minv, TOMO_SHAPE, reps=5)
    t.update({f"tomogram_backproject_{k}": v for k, v in tomogram_c.items()})
    t["tomogram_backproject_bound_ms"], t[
        "tomogram_backproject_bound_by"] = backproject_bound_ms(
            len(tomo_ms), TOMO_SHAPE, TOMO_SHAPE[1:], True)
    t["tomogram_backproject_floor_ms"] = backproject_floor_ms(
        len(tomo_ms), TOMO_SHAPE)
    t["backproject_window_misses"] = BP.window_misses(dev) - misses_before
    assert t["backproject_window_misses"] == 0, t["backproject_window_misses"]
    del tomo_projs
    vol_dev = torch.from_numpy(vol_np).to(dev)
    # what the pitched layout costs: the copy the one-shot call makes of a
    # 250-wide volume, and A on the pitched against the contiguous volume
    t["pitched_copy_ms"] = time_ms(
        torch, lambda: pitched(vol_dev, copy=True), reps=5)
    rots_dev = torch.from_numpy(rots).to(dev)
    rot_patches = [walk_patch(m) for m in rots]
    # linear on the raw volume, cubic on its coefficients: the contiguous
    # 250-wide copy is read a float at a time, the pitched one with
    # float4 cubic rows
    for order, name, pitched_vol in ((1, "linear", sv_lin.data),
                                     (3, "cubic", sv_cub.data)):
        for layout, v in (("contiguous", pitched_vol.contiguous()),
                          ("pitched", pitched_vol)):
            state = {"i": 0}

            def walk_layout(v=v, order=order):
                i = state["i"] % N_ROT
                walk(v, rots_dev[i], order, out=out, patch=rot_patches[i])
                state["i"] += 1

            t[f"random_{name}_walk_{layout}_ms"] = time_ms(
                torch, walk_layout, reps=2 * N_ROT)
    t["prefilter_mirror_ms"] = time_ms(
        torch, lambda: bspline_prefilter(vol_dev), reps=5)
    t["prefilter_clamp_ms"] = time_ms(
        torch, lambda: bspline_prefilter(vol_dev, "clamp"), reps=2, warmup=1)
    t["one_shot_filt_bspline_ms"] = time_ms(
        torch, lambda: vt.affine(vol_dev, rots[0], "filt_bspline",
                                 device="cuda", output="device"), reps=5)
    t["one_shot_linear_ms"] = time_ms(
        torch, lambda: vt.affine(vol_dev, rots[0], "linear", device="cuda",
                                 output="device"), reps=5)
    emit("times", shape=list(big), method="CUDA events, back-to-back "
         "launches after warm-up; the 62.5 MB volume exceeds the 50 MB L2",
         **t)

    # -------------------------------------------------- 8. registration
    from voltools_tpu_torch import native
    from voltools_tpu_torch.models import phase_cross_correlation, register
    from voltools_tpu_torch.models.registration import _resize
    from voltools_tpu_torch.utils import rodrigues_matrix

    rshape = (REG_SIZE,) * 3
    reference = blob_phantom(np, ndimage, REG_SIZE)
    rcenter = tuple((s - 1) / 2 for s in rshape)
    w_true = np.asarray(REG_W_TRUE, np.float32)
    t_true = np.asarray(REG_T_TRUE, np.float32)
    m_true = rodrigues_matrix(torch.from_numpy(w_true), rcenter).numpy()
    m_true[:3, 3] -= t_true
    ref_dev = torch.from_numpy(reference).to(dev)
    moving = affine_sample(ref_dev, torch.from_numpy(m_true).to(dev),
                           "linear").cpu().numpy()
    noise = np.random.default_rng(1)
    moving = (1.7 * moving + 0.2
              + noise.normal(0, 0.01, moving.shape)).astype(np.float32)
    mov_dev = torch.from_numpy(moving).to(dev)
    # register(moving, reference) recovers the inverse of m_true: axis-angle
    # -w_true, and the t' that solves c - R'c - R't' = inv(m_true)[:3, 3]
    # (examples/registration.py:67-74)
    w_expect = -w_true
    r_inv = m_true[:3, :3].T
    c_arr = np.asarray(rcenter, np.float32)
    t_expect = np.linalg.solve(r_inv, c_arr - r_inv @ c_arr
                               - np.linalg.inv(m_true)[:3, 3])
    kw = dict(model="rigid", loss="ncc", levels=REG_LEVELS, steps=REG_STEPS)
    interps = ("linear", "filt_bspline")
    # warm-up: cuFFT's plans and the sampler's first launches
    for interp in interps:
        register(mov_dev, ref_dev, model="rigid", steps=2, levels=REG_LEVELS,
                 interpolation=interp, device="cuda")

    torch.cuda.synchronize()
    zero_launches()
    results, register_ms = {}, {}
    for interp in interps:
        register_ms[interp], results[interp] = event_ms(
            torch, lambda: register(mov_dev, ref_dev, interpolation=interp,
                                    device="cuda", **kw))
    shift = phase_cross_correlation(ref_dev, mov_dev, upsample=PCC_UPSAMPLE,
                                    device="cuda")
    registered = {interp: results[interp].apply(
        mov_dev, interpolation=interp, device="cuda", output="device")
        for interp in interps}
    torch.cuda.synchronize()
    reg_launches = launch_counts()
    expected_reg = planned([(results[interp].matrix, rshape,
                             spline_order(interp)) for interp in interps])
    assert reg_launches == expected_reg, (reg_launches, expected_reg)
    assert reg_launches[K.NAME] > 0, reg_launches

    recovery = {}
    inner = (slice(6, -6),) * 3

    def norm(v):
        v = v[inner]
        return (v - v.mean()) / v.std()

    for interp in interps:
        res = results[interp]
        deg = float(np.degrees(np.linalg.norm(res.params["w"] - w_expect)))
        t_err = float(np.abs(res.params["t"] - t_expect).max())
        assert np.isfinite(res.loss_history).all(), interp
        assert len(res.loss_history) == REG_LEVELS * REG_STEPS
        assert deg <= REG_DEG_TOL and t_err <= REG_T_TOL, (interp, deg,
                                                            t_err)
        # the applied result against the plain version, and the example's
        # normalised L1 misfit before and after
        out = registered[interp]
        assert out.shape == rshape
        want = affine_sample(mov_dev, torch.from_numpy(res.matrix).to(dev),
                             interp)
        off, _ = errors(torch, out, want, res.matrix)
        assert off <= ATOL, ("apply", interp, off)
        before = float((norm(mov_dev) - norm(ref_dev)).abs().mean())
        after = float((norm(out) - norm(ref_dev)).abs().mean())
        assert after < before, (interp, before, after)
        recovery[interp] = {
            "w": res.params["w"].tolist(), "t": res.params["t"].tolist(),
            "rotation_error_deg": deg, "translation_error_vox": t_err,
            "apply_max_abs_err_vs_plain": off,
            "misfit_before": before, "misfit_after": after,
            "first_loss": float(res.loss_history[0]),
            "last_loss": float(res.loss_history[-1])}

    # the phase correlation on the CPU: this phantom's upsampled peak is a
    # near tie (two grid points 2e-4 apart on the CPU), which FFTs of
    # another rounding may break the other way, so the two devices agree
    # within one grid step
    shift_cpu = phase_cross_correlation(reference, moving,
                                        upsample=PCC_UPSAMPLE, device="cpu")
    shift_diff = float((shift.cpu() - shift_cpu).abs().max())
    assert shift_diff <= 1.0 / PCC_UPSAMPLE + 1e-6, (shift.tolist(),
                                                     shift_cpu.tolist())
    # the same linear call on the CPU (plain torch on the host's cores),
    # from the card's phase-correlation seed (the card's register drew
    # it); the cubic one would take minutes there (64 taps a voxel), and
    # the card tests hold it at 32^3
    t0 = time.perf_counter()
    cpu_res = register(moving, reference, interpolation="linear",
                       device="cpu", init_translation=shift.cpu().numpy(),
                       **kw)
    cpu_seconds = time.perf_counter() - t0
    gpu_res = results["linear"]
    w_diff = float(np.abs(gpu_res.params["w"] - cpu_res.params["w"]).max())
    t_diff = float(np.abs(gpu_res.params["t"] - cpu_res.params["t"]).max())
    loss_rel = float(np.max(np.abs(gpu_res.loss_history[:5]
                                   - cpu_res.loss_history[:5])
                            / np.abs(cpu_res.loss_history[:5])))
    assert w_diff <= REG_W_CPU_TOL and t_diff <= REG_T_CPU_TOL, (w_diff,
                                                                t_diff)
    assert loss_rel <= REG_LOSS_RTOL, loss_rel

    # times: the phase correlation alone, and an Adam step per level as the
    # slope between two register calls on that level's volumes (one level,
    # no phase correlation, the level's edge)
    pcc_ms = time_ms(torch, lambda: phase_cross_correlation(
        ref_dev, mov_dev, upsample=PCC_UPSAMPLE, device="cuda"), reps=10)
    edge = max(1, round(0.05 * REG_SIZE))
    step_ms, step_ops, step_busy, step_syncs = {}, {}, {}, {}
    for level in range(REG_LEVELS - 1, -1, -1):
        lshape = tuple(max(4, round(s / 2 ** level)) for s in rshape)
        if lshape != rshape:
            lmov, lref = _resize(mov_dev, lshape), _resize(ref_dev, lshape)
            ledge = min(max(1, round(edge * lshape[0] / REG_SIZE)),
                        (min(lshape) - 1) // 2)
        else:
            lmov, lref, ledge = mov_dev, ref_dev, edge
        for interp in interps:
            ms = [event_ms(torch, lambda n=n: register(
                lmov, lref, model="rigid", loss="ncc", steps=n,
                interpolation=interp, edge=ledge, init_translation=None,
                device="cuda"))[0] for n in REG_TIMED_STEPS]
            key = f"level_{level}_{lshape[0]}^3_{interp}"
            step_ms[key] = ((ms[1] - ms[0])
                            / (REG_TIMED_STEPS[1] - REG_TIMED_STEPS[0]))
            ops = [device_ops(torch, lambda n=n: register(
                lmov, lref, model="rigid", loss="ncc", steps=n,
                interpolation=interp, edge=ledge, init_translation=None,
                device="cuda")) for n in REG_TIMED_STEPS]
            if None in ops:
                step_ops[key] = step_busy[key] = step_syncs[key] = None
            else:
                span = REG_TIMED_STEPS[1] - REG_TIMED_STEPS[0]
                step_ops[key] = (ops[1][0] - ops[0][0]) / span
                step_busy[key] = (ops[1][1] - ops[0][1]) / span
                step_syncs[key] = (ops[1][2] - ops[0][2]) / span
                # the loop keeps its state on the device: no step waits
                assert step_syncs[key] == 0, (key, step_syncs[key])
    emit("registration", shape=list(rshape), model="rigid", loss="ncc",
         levels=REG_LEVELS, steps=REG_STEPS,
         w_expect=w_expect.tolist(), t_expect=t_expect.tolist(),
         recovery=recovery, bounds={"rotation_deg": REG_DEG_TOL,
                                    "translation_vox": REG_T_TOL},
         phase_correlation_shift=shift.tolist(),
         phase_correlation_shift_cpu=shift_cpu.tolist(),
         cpu_linear={"seconds": cpu_seconds, "w_max_diff": w_diff,
                     "t_max_diff": t_diff, "first_5_loss_max_rel": loss_rel,
                     "shift_max_diff": shift_diff,
                     "torch_threads": torch.get_num_threads(),
                     "tolerances": {"w": REG_W_CPU_TOL, "t": REG_T_CPU_TOL,
                                    "loss_rtol": REG_LOSS_RTOL}},
         launches=reg_launches, expected_launches=expected_reg,
         register_ms=register_ms, adam_step_ms=step_ms,
         adam_step_device_ops=step_ops,
         adam_step_device_busy_ms=step_busy,
         adam_step_host_syncs=step_syncs,
         phase_correlation_ms=pcc_ms,
         method="CUDA events; a step per level is the slope between "
         f"register calls of {REG_TIMED_STEPS} steps on that level; device "
         "operations (kernels and copies) and the ms they keep the device "
         "busy by torch.profiler, null where it recorded none")
    del registered, mov_dev, ref_dev

    # -------------------------------------------------- 9. cpu_backends
    cached = native.library_path().is_file()
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError(f"native backend did not build: "
                           f"{native._BUILD_ERROR}")
    build_seconds = time.perf_counter() - t0
    host = {"cpu": host_cpu_model(), "cores": os.cpu_count()}
    rows = []
    for i in range(CPU_BACKEND_ROTATIONS):
        m = rots[i]
        for order, interp in ((1, "linear"), (3, "filt_bspline")):
            want = walk(coef[order], torch.from_numpy(m).to(dev), order)
            got = {}
            for backend in ("native", "scipy"):
                t0 = time.perf_counter()
                got[backend] = vt.affine(vol_np, m, interp, device="cpu",
                                         cpu_backend=backend)
                seconds = time.perf_counter() - t0
                off, every = errors(torch, torch.from_numpy(
                    got[backend]).to(dev), want, m)
                assert off <= SCIPY_ATOL, (backend, interp, i, off)
                rows.append({"backend": backend, "interpolation": interp,
                             "rotation": i, "host_ms": seconds * 1e3,
                             "max_abs_err_vs_A": off,
                             "max_abs_err_vs_A_all_voxels": every})
            rows.append({"native_vs_scipy_max_abs": float(np.abs(
                got["native"] - got["scipy"]).max()),
                "interpolation": interp, "rotation": i})
    emit("cpu_backends", shape=list(big), host=host,
         native_build_seconds=build_seconds, native_built_now=not cached,
         gxx_flags=" ".join(native.GXX_FLAGS), atol=SCIPY_ATOL, calls=rows,
         note="host times on the card's host CPU, not the card's")

    # ---------------------------------------------------- 10. sharded
    from voltools_tpu_torch.parallel import (Mesh, ShardedVolume,
                                             halo_for_matrix, make_mesh,
                                             sharded_affine_batch)
    from voltools_tpu_torch.parallel import sharded as sharded_module

    mesh = Mesh([dev] * SHARDS)
    local_ms = {
        "translate_5_0_0": translation_matrix((5.0, 0.0, 0.0)),
        "sxyz_3_-4_5": transform_matrix(rotation=(3, -4, 5),
                                        rotation_order="sxyz",
                                        center=center)}
    local_ms = {k: np.asarray(v, np.float32) for k, v in local_ms.items()}

    def shard_routes(sv, m):
        """The body a sharded call of ``m`` takes, and what planner.route
        gives for each shard's launch, from the shard's own matrix (the
        output's slab shift, and the source's for the halo body) and
        source: the extended slab or the gathered volume."""
        shards = sv.mesh.size
        local = -(-SIZE // shards)
        halo = halo_for_matrix(big, m, sv.interpolation)
        if halo is not None and halo + 1 > local:
            halo = None
        body = "halo" if halo is not None else sv.global_strategy
        if body == "stream":
            return body, []
        routes = []
        for i in range(shards):
            start = np.float32(i * local)
            mi = m.copy()
            mi[:, 3] += m[:, 0] * start
            src = (shards * local,) + big[1:]
            if halo is not None:
                mi[0, 3] += np.float32(halo) - start
                src = (local + 2 * halo,) + big[1:]
            routes.append(planner.route(mi, src, sv.interpolation, sv.mode,
                                        (local,) + big[1:]))
        return body, routes

    def counted(routes):
        n = {S.NAME: 0, K.NAME: 0, MU.NAME: 0, MU.NOISE_NAME: 0,
             ZP.NAME: 0, MS.NAME: 0, MS.FINISH_NAME: 0}
        for r in routes:
            n[S.NAME if r.plan is not None else K.NAME] += 1
        return n

    shard_launches = dict.fromkeys(launch_counts(), 0)
    shard_entries = dict.fromkeys(entry_counts(), 0)

    def launched(fn, routes, backprojections=0, d1_launches=0,
                 d2_launches=0):
        """Run ``fn`` with the counters set to 0 just before; the counts
        just after must be what ``routes`` give, C's ``backprojections``
        and D1's and D2's launches, every D1 launch on its ring entry and
        every D2 launch on the line path; add them to the phase's."""
        torch.cuda.synchronize()
        zero_launches()
        result = fn()
        torch.cuda.synchronize()
        got = launch_counts()
        want = dict(counted(routes), **{BP.NAME: backprojections,
                                        D1: d1_launches, D2: d2_launches})
        assert got == want, (got, want)
        entries = entry_counts()
        assert entries == {"d1_ring": d1_launches, "d1_step": 0,
                           "d2_line": d2_launches}, entries
        for k in got:
            shard_launches[k] += got[k]
        for k in entries:
            shard_entries[k] += entries[k]
        return result

    def kernel_of(route):
        return "slab" if route.plan is not None else "walk"

    rows = []
    worst_sharded = {"halo": 0.0, "gather": 0.0, "stream": 0.0}
    t0 = time.perf_counter()
    single_border = vt.StaticVolume(vol_np, "filt_bspline", device="cuda",
                                    mode="border", cval=1.5)
    # (name, single-device volume, ShardedVolume keywords, cases)
    configs = []
    for interp, single in (("linear", sv_lin), ("filt_bspline", sv_cub)):
        n_stream = N_SHARD_ROT if interp == "linear" \
            else STREAM_CUBIC_ROTATIONS
        cases = [("stream", name, m) for name, m in local_ms.items()]
        cases += [("gather", f"random_{i}", rots[i])
                  for i in range(N_SHARD_ROT)]
        cases += [("stream", f"random_{i}", rots[i])
                  for i in range(n_stream)]
        configs.append((interp, single, dict(interpolation=interp), cases))
    configs.append(("filt_bspline_border_cval_1.5", single_border,
                    dict(interpolation="filt_bspline", mode="border",
                         cval=1.5),
                    [("stream", "sxyz_3_-4_5", local_ms["sxyz_3_-4_5"])]))
    svs = {}
    for name, single, kw, cases in configs:
        for strategy in sorted({c[0] for c in cases}):
            svs[name, strategy] = ShardedVolume(
                vol_np, mesh=mesh, global_strategy=strategy, **kw)
        for strategy, mname, m in cases:
            sv = svs[name, strategy]
            body, routes = shard_routes(sv, m)
            # the stream body: D1's ring entry once per shard (its slabs
            # all lie on the one card), A and B never
            slabs = launched(lambda: sv.affine(m, output="device"), routes,
                             d1_launches=SHARDS if body == "stream" else 0)
            assert len(slabs) == SHARDS and all(
                x.device == dev for x in slabs), [x.device for x in slabs]
            got = torch.cat(slabs)
            assert got.shape == big
            want = single.affine(m, output="device")
            plain = affine_sample(single.data, torch.from_numpy(m).to(dev),
                                  interp_of[spline_order(sv.interpolation)],
                                  sv.mode, sv.cval, prefiltered=True)
            half = sv.mode == "border"
            vs_single = errors(torch, got, want, m, half)
            vs_plain = errors(torch, got, plain, m, half)
            tol = SHARD_STREAM_ATOL if body == "stream" else SHARD_ATOL
            assert max(vs_single[0], vs_plain[0]) <= tol, (
                name, body, mname, vs_single, vs_plain)
            worst_sharded[body] = max(worst_sharded[body], vs_single[0],
                                      vs_plain[0])
            rows.append({"volume": name, "body": body, "matrix": mname,
                         "kernels": [kernel_of(r) for r in routes],
                         "max_abs_err_vs_single": vs_single[0],
                         "max_abs_err_vs_plain": vs_plain[0],
                         "all_voxels_vs_single": vs_single[1], "atol": tol,
                         "equal_to_single": bool(torch.equal(got, want))})
            del slabs, got, want, plain

    # a 2-shard mesh: 250 planes divide it and the slabs are thicker than
    # the FIR's 18 planes, so construction prefilters shard by shard
    sv2 = ShardedVolume(vol_np, "filt_bspline", mesh=Mesh([dev] * 2))
    prefilter_err = float((torch.cat(sv2.data) - sv_cub.data).abs().max())
    assert prefilter_err <= SHARD_PREFILTER_ATOL, prefilter_err
    m = local_ms["sxyz_3_-4_5"]
    body, routes = shard_routes(sv2, m)
    got = torch.cat(launched(lambda: sv2.affine(m, output="device"), routes))
    two_shard_err = errors(torch, got, sv_cub.affine(m, output="device"),
                           m)[0]
    assert two_shard_err <= SHARD_ATOL, two_shard_err
    # make_mesh(): one shard a CUDA device (one on this machine); through
    # the gather body, the one launch is StaticVolume.affine's own
    sv1 = ShardedVolume(vol_np, "linear", mesh=make_mesh(),
                        global_strategy="gather")
    body1, routes = shard_routes(sv1, rots[0])
    got = torch.cat(launched(lambda: sv1.affine(rots[0], output="device"),
                             routes))
    want = sv_lin.affine(rots[0], output="device")
    make_mesh_err = errors(torch, got, want, rots[0])[0]
    assert make_mesh_err <= SHARD_ATOL, make_mesh_err
    make_mesh_equal = bool(torch.equal(got, want))
    del sv2, sv1, got, want

    # sharded_affine_batch: the 16 random rotations in both orders, and
    # the reconstruction's 41 tilts (44 after padding, 11 a shard), each
    # share one launch; every launch's last_dispatch() is recorded
    dispatches = []
    resample = sharded_module._resample

    def recording(*args, **kwargs):
        out = resample(*args, **kwargs)
        dispatches.append(vt.last_dispatch())
        return out

    batch_rows = []
    sharded_module._resample = recording
    try:
        for bname, ms, interp, single in (
                ("random_linear", rots, "linear", sv_lin),
                ("random_filt_bspline", rots, "filt_bspline", sv_cub),
                ("recon_tilt_linear", rms, "linear", sv_lin)):
            padded = np.concatenate(
                [ms, np.repeat(ms[-1:], (-len(ms)) % SHARDS, axis=0)])
            per = len(padded) // SHARDS
            routes = [planner.route(padded[i * per:(i + 1) * per], big,
                                    interp) for i in range(SHARDS)]
            del dispatches[:]
            stacks = launched(lambda: sharded_affine_batch(
                vol_dev, ms, interp, mesh=mesh, output="device"), routes)
            assert [d["impl"] for d in dispatches] == ["cuda"] * SHARDS
            assert [d["variant"] is not None for d in dispatches] == [
                r.plan is not None for r in routes], dispatches
            got = torch.cat(stacks)
            want = single.affine_batch(ms, output="device")
            assert got.shape == want.shape == (len(ms),) + big
            errs = [errors(torch, got[i], want[i], ms[i])[0]
                    for i in range(len(ms))]
            plain_errs = [errors(torch, got[i], affine_sample(
                single.data, torch.from_numpy(ms[i]).to(dev),
                interp_of[spline_order(interp)], prefiltered=True),
                ms[i])[0] for i in range(len(ms))]
            assert max(errs + plain_errs) <= SHARD_ATOL, (bname, max(errs),
                                                          max(plain_errs))
            batch_rows.append({
                "set": bname, "matrices": len(ms), "per_shard": per,
                "kernels": [kernel_of(r) for r in routes],
                "last_dispatch": [d["reason"] for d in dispatches],
                "max_abs_err_vs_single": max(errs),
                "max_abs_err_vs_plain": max(plain_errs),
                "equal_to_single": bool(torch.equal(got, want))})
            del stacks, got, want
    finally:
        sharded_module._resample = resample

    # the mesh modes of the reconstructions on the tilt phase's series
    recon_rows = {}
    wbp_one = wbp_reconstruct(rprojs, rms, big, device="cuda",
                              output="device")
    scale = float(wbp_one.abs().max())
    # C launches once per shard in each mesh WBP, and per shard for the
    # column sums and each iteration in the mesh SIRT; each result equals
    # the same call with C's plain version bit for bit
    recon_equal = {}
    for mesh_shard in ("tilts", "volume"):
        res, plain = (launched(lambda: wbp_reconstruct(
            rprojs, rms, big, mesh=mesh, mesh_shard=mesh_shard,
            output="device", _plain_adjoint=p), [],
            0 if p else SHARDS) for p in (False, True))
        got = res if mesh_shard == "tilts" else torch.cat(res)
        recon_equal[f"wbp_{mesh_shard}"] = bool(torch.equal(
            got, plain if mesh_shard == "tilts" else torch.cat(plain)))
        assert recon_equal[f"wbp_{mesh_shard}"], mesh_shard
        err = float((got - wbp_one).abs().max()) / scale
        assert err <= RECON_RTOL, (mesh_shard, err)
        recon_rows[f"wbp_{mesh_shard}"] = err
    sirt_ms = {}
    # C and D2 once per shard for the normalisers and for each iteration
    sirt_ms[SHARD_SIRT_ITERATIONS], res = event_ms(torch, lambda: launched(
        lambda: sirt_reconstruct(rprojs, rms, big,
                                 iterations=SHARD_SIRT_ITERATIONS,
                                 mesh=mesh, output="device"), [],
        SHARDS * (1 + SHARD_SIRT_ITERATIONS),
        d2_launches=SHARDS * (1 + SHARD_SIRT_ITERATIONS)))
    sirt_one = sirt_reconstruct(rprojs, rms, big,
                                iterations=SHARD_SIRT_ITERATIONS,
                                device="cuda", output="device",
                                _plain_forward=True, _plain_adjoint=True)
    got = torch.cat(res)
    assert got.shape == big and torch.isfinite(got).all()
    err = float((got - sirt_one).abs().max()) / float(sirt_one.abs().max())
    assert err <= RECON_RTOL, ("sirt", err)
    recon_rows["sirt"] = err
    del res, got, sirt_one
    assert all(v > 0 for k, v in shard_launches.items()
               if k not in (MU.NAME, MU.NOISE_NAME, ZP.NAME, MS.NAME,
                            MS.FINISH_NAME)), \
        shard_launches
    assert S.overflows(dev) == 0
    check_seconds = time.perf_counter() - t0

    # times: CUDA events after warm-up
    st = {}
    for name, single, cases in ((n, s, c) for n, s, _, c in configs[:2]):
        order_name = "linear" if name == "linear" else "cubic"
        for body, strategy, m in (
                ("halo", "stream", local_ms["sxyz_3_-4_5"]),
                ("gather", "gather", rots[0]),
                ("stream", "stream", rots[0])):
            sv = svs[name, strategy]
            reps = 2 if body == "stream" else 10
            st[f"{body}_{order_name}_ms"] = time_ms(
                torch, lambda: sv.affine(m, output="device"), reps=reps,
                warmup=1)
            st[f"static_volume_affine_{order_name}_same_matrix_ms_"
               f"{body}"] = time_ms(
                torch, lambda: single.affine(m, output="device"), reps=10)
    # device operations a call runs and the ms they keep the device busy
    # (torch.profiler), one linear call a body; the host's waits on the
    # device in it, less those of a call that only fills one float (the
    # closing synchronize and the profiler's own), must be none: no body
    # waits on the device before it returns
    base = host_syncs(torch, lambda: torch.zeros(1, device=dev))
    for body, strategy, m in (("halo", "stream", local_ms["sxyz_3_-4_5"]),
                              ("gather", "gather", rots[0]),
                              ("stream", "stream", rots[0])):
        sv = svs["linear", strategy]
        ops = device_ops(torch, lambda: sv.affine(m, output="device"))
        st[f"{body}_linear_device_ops"], st[f"{body}_linear_busy_ms"] = (
            ops[:2] if ops else (None, None))
        st[f"{body}_linear_host_syncs"] = host_syncs(
            torch, lambda: sv.affine(m, output="device")) - base
        assert st[f"{body}_linear_host_syncs"] == 0, (body, base)
    for strategy in ("stream", "gather"):
        sv = svs["linear", strategy]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = sv.affine(rots[0], output="device")
        torch.cuda.synchronize()
        st[f"{strategy}_peak_mib_above_resident"] = (
            torch.cuda.max_memory_allocated(dev) - before) / 2 ** 20
        del res
    st["resident_volume_mib"] = 4 * SIZE ** 3 / 2 ** 20
    for bname, ms, interp, single in (
            ("random_linear", rots, "linear", sv_lin),
            ("random_filt_bspline", rots, "filt_bspline", sv_cub),
            ("recon_tilt_linear", rms, "linear", sv_lin)):
        st[f"batch_{bname}_ms_per_matrix"] = time_ms(
            torch, lambda: sharded_affine_batch(vol_dev, ms, interp,
                                                mesh=mesh, output="device"),
            reps=2, warmup=1) / len(ms)
        st[f"static_volume_affine_batch_{bname}_ms_per_matrix"] = time_ms(
            torch, lambda: single.affine_batch(ms, output="device"),
            reps=2, warmup=1) / len(ms)
    for mesh_shard in ("tilts", "volume"):
        st[f"wbp_{mesh_shard}_ms"] = time_ms(torch, lambda: wbp_reconstruct(
            rprojs, rms, big, mesh=mesh, mesh_shard=mesh_shard,
            output="device"), reps=2, warmup=1)
    st["wbp_single_ms"] = time_ms(torch, lambda: wbp_reconstruct(
        rprojs, rms, big, device="cuda", output="device"), reps=2, warmup=1)
    sirt_ms[1], res = event_ms(torch, lambda: sirt_reconstruct(
        rprojs, rms, big, iterations=1, mesh=mesh, output="device"))
    # the mesh SIRT with C's plain version, bit for bit, one iteration
    plain = launched(lambda: sirt_reconstruct(
        rprojs, rms, big, iterations=1, mesh=mesh, output="device",
        _plain_adjoint=True), [], d2_launches=SHARDS * 2)
    recon_equal["sirt_1_iteration"] = bool(torch.equal(torch.cat(res),
                                                       torch.cat(plain)))
    assert recon_equal["sirt_1_iteration"], "mesh SIRT: C != plain version"
    del res, plain
    st["sirt_mesh_ms_per_iteration"] = (
        sirt_ms[SHARD_SIRT_ITERATIONS] - sirt_ms[1]) / (
        SHARD_SIRT_ITERATIONS - 1)
    st["sirt_mesh_setup_ms"] = sirt_ms[1] - st["sirt_mesh_ms_per_iteration"]
    one = [event_ms(torch, lambda n=n: sirt_reconstruct(
        rprojs, rms, big, iterations=n, device="cuda",
        output="device"))[0] for n in (1, SHARD_SIRT_ITERATIONS)]
    st["sirt_single_ms_per_iteration"] = (one[1] - one[0]) / (
        SHARD_SIRT_ITERATIONS - 1)
    # the mesh SIRT with D2's plain version as its forward, timed once at
    # one iteration and at two
    plain_sirt = [event_ms(torch, lambda n=n: sirt_reconstruct(
        rprojs, rms, big, iterations=n, mesh=mesh, output="device",
        _plain_forward=True))[0] for n in (1, 2)]
    st["sirt_mesh_plain_forward_ms_per_iteration"] = (plain_sirt[1]
                                                      - plain_sirt[0])

    # D1 in the stream body itself, its 4 ring launches a rotation on 4
    # shards: the body's time, the device time of its launches alone, what
    # the profiler records of it, and its plain steps (plain=True) timed
    # once; in the same rounds, the 16 launches of its per-step entry and
    # of D before its redesign (tools/partial_sample_baseline.cu) over the
    # same rings, each equal to the body's output first
    from torch.nn.functional import grid_sample
    local = -(-SIZE // SHARDS)
    shifted = [_shifted(rots[0], np.float32(i * local))
               for i in range(SHARDS)]
    rings = [[(i - k) % SHARDS for k in range(SHARDS)]
             for i in range(SHARDS)]
    d_times = {}
    for name, order_name in (("linear", "linear"), ("filt_bspline", "cubic")):
        sv = svs[name, "stream"]
        order = spline_order(sv.interpolation)
        body = functools.partial(sv._stream_body, rots[0])
        d_times[f"d1_{order_name}_body_ms"] = time_ms(torch, body, reps=10)
        want = body()
        accs = [torch.empty_like(w) for w in want]

        def step_calls(baseline):
            """The per-step launches over each shard's ring from a zero
            accumulator, one call a launch: the committed entry's, or PR
            14's."""
            calls = []
            for i, ring in enumerate(rings):
                rows = np.ascontiguousarray(shifted[i][:3])
                for k, j in enumerate(ring):
                    last = k == SHARDS - 1
                    if not baseline:
                        calls.append(functools.partial(
                            d1, sv.data[j], shifted[i], j * local, big,
                            order, sv.mode, accs[i], last, sv.cval))
                        continue

                    def launch(i=i, j=j, rows=rows, last=last):
                        code = d_baseline.partial_sample_baseline_launch(
                            sv.data[j].data_ptr(), local, j * local, *big,
                            rows.ctypes.data, accs[i].data_ptr(),
                            *accs[i].shape, order, int(sv.mode == "border"),
                            int(last), sv.cval,
                            torch.cuda.current_stream().cuda_stream)
                        assert code == 0, code
                    calls.append(launch)
            return calls

        def zero_accs():
            for a in accs:
                a.zero_()

        for baseline in (False, True):
            zero_accs()
            for call in step_calls(baseline):
                call()
            assert all(torch.equal(a, w) for a, w in zip(accs, want)), (
                order_name, "baseline" if baseline else "per step")
        del want
        runs = {"ring": [], "per_step": [], "baseline": []}
        for _ in range(5):
            runs["ring"].append(queued_launch_ms(
                torch, body, sharded_module, "partial_sample_ring"))
            runs["per_step"].append(queued_ms(torch, step_calls(False),
                                              zero_accs))
            runs["baseline"].append(queued_ms(torch, step_calls(True),
                                              zero_accs))
        assert all(len(k) == SHARDS for k in runs["ring"]), runs["ring"]
        for kind, kernel in runs.items():
            sums = sorted(sum(k) for k in kernel)
            label = "kernel" if kind == "ring" else kind
            d_times[f"d1_{order_name}_{label}_ms"] = sums[len(sums) // 2]
            d_times[f"d1_{order_name}_{label}_ms_range"] = [sums[0],
                                                            sums[-1]]
            d_times[f"d1_{order_name}_{label}_launch_ms"] = kernel[0]
        del accs
        d_times[f"d1_{order_name}_profiler"] = profiler_view(torch, body)
        d_times[f"d1_{order_name}_plain_ms"] = event_ms(
            torch, lambda: sv._stream_body(rots[0], plain=True))[0]
        for k, v in d1_bound_ms(torch, vt, shifted, big, local, order,
                                sv.mode, dev).items():
            d_times[f"d1_{order_name}_{k}"] = v
    # grid_sample, trilinear with zero padding, on each slab at the shard's
    # coordinates: the 16 calls of a rotation, timed only
    sv = svs["linear", "stream"]
    grids = []
    for i in range(SHARDS):
        c = vt.ops.affine_coords((local,) + big[1:], shifted[i], device=dev)
        for j in range(SHARDS):
            grids.append((j, torch.stack(
                [c[2] * (2.0 / (big[2] - 1)) - 1.0,
                 c[1] * (2.0 / (big[1] - 1)) - 1.0,
                 (c[0] - j * local) * (2.0 / (local - 1)) - 1.0], -1)[None]))
        del c
    d_times["d1_grid_sample_ms"] = time_ms(torch, lambda: [grid_sample(
        sv.data[j][None, None], g, mode="bilinear", padding_mode="zeros",
        align_corners=True) for j, g in grids], reps=5)
    del grids

    # D2: a sweep over the reconstruction's 41 tilts, one launch a shard, on
    # the line path (the series leaves array axis 2 alone), on the general
    # kernel and on D before its redesign, in turns
    assert PS.line_axis(rms, 0) == 2
    xs_full = torch.zeros((local * SHARDS,) + big[1:], device=dev)
    xs_full[:SIZE] = vol_dev
    xs = [xs_full[i * local:(i + 1) * local] for i in range(SHARDS)]
    offs = [float(np.float32(i * local)) for i in range(SHARDS)]

    # the sweep calls D2 through a namespace of its own, which
    # queued_launch_ms patches: the wrapper's own module global is the
    # launch counter's holder and stays as it is
    d2_call = types.SimpleNamespace(partial_project=PS.partial_project)

    def sweep(general=False):
        return [d2_call.partial_project(xs[i], rms, offs[i], big, 0,
                                        _force_general=general)
                for i in range(SHARDS)]

    d2_rows = torch.from_numpy(np.ascontiguousarray(rms[:, :3])).to(dev)
    d2_outs = [torch.empty((len(rms),) + big[1:], device=dev)
               for _ in range(SHARDS)]

    def baseline_sweep_calls():
        def launch(i):
            code = d_baseline.partial_project_baseline_launch(
                xs[i].data_ptr(), *xs[i].shape, d2_rows.data_ptr(),
                len(rms), offs[i], *big, 0, d2_outs[i].data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            assert code == 0, code
        return [functools.partial(launch, i) for i in range(SHARDS)]

    d_times["d2_sweep_ms"] = time_ms(torch, sweep, reps=10)
    d_times["d2_general_sweep_ms"] = time_ms(
        torch, lambda: sweep(general=True), reps=10)
    line_out, general_out = sweep(), sweep(general=True)
    for call in baseline_sweep_calls():
        call()
    for a, b, c in zip(line_out, general_out, d2_outs):
        assert torch.equal(a, b) and torch.equal(b, c), "D2 sweeps differ"
    del line_out, general_out
    runs = {"line": [], "general": [], "baseline": []}
    for _ in range(5):
        runs["line"].append(queued_launch_ms(torch, sweep, d2_call,
                                             "partial_project"))
        runs["general"].append(queued_launch_ms(
            torch, lambda: sweep(general=True), d2_call, "partial_project"))
        runs["baseline"].append(queued_ms(torch, baseline_sweep_calls()))
    assert all(len(k) == SHARDS for r in runs.values() for k in r), runs
    for kind, kernel in runs.items():
        sums = sorted(sum(k) for k in kernel)
        label = "kernel" if kind == "line" else kind
        d_times[f"d2_{label}_ms"] = sums[len(sums) // 2]
        d_times[f"d2_{label}_ms_range"] = [sums[0], sums[-1]]
        d_times[f"d2_{label}_launch_ms"] = kernel[0]
    del d2_outs, d2_rows
    d_times["d2_profiler"] = profiler_view(torch, sweep)
    d_times["d2_plain_ms"] = event_ms(torch, lambda: [
        PS.plain_partial_project(xs[i], rms, offs[i], big, 0)
        for i in range(SHARDS)])[0]
    # its bounds: the slabs read and the projections written once over the
    # memory rate, against, over the fp32 rate, the samples whose stencil
    # meets a slab (inside, floor(z - off) in [-1, local - 1]) at
    # FLOPS_INSIDE linear and one add each (the general sample), or at a
    # bilinear sample each and a line's work at each (tilt, line, plane)
    # that has one (the line geometry: its samples do not depend on b);
    # and the floors of a design that keeps bit parity (PARITY_OPS)
    from voltools_tpu_torch.ops.interpolation import _inside
    samples = line_planes = 0
    library_ms = 0.0
    for m in rms:
        c = vt.ops.affine_coords(big, m, device=dev)
        inside = _inside(c[0], c[1], c[2], big, "constant")
        for i in range(SHARDS):
            f = torch.floor(c[0] - offs[i])
            meets = inside & (f >= -1) & (f <= local - 1)
            samples += int(meets.sum())
            line_planes += int(meets[..., 0].sum())
        del c, inside, f, meets
    assert samples == line_planes * SIZE, (samples, line_planes)
    tb = 4.0 * SHARDS * (local * SIZE * SIZE + len(rms) * SIZE * SIZE) \
        / HBM_BYTES_PER_S
    for label, ops, rate in (
            ("bound", (FLOPS_INSIDE[1] + 1) * samples, FP32_FLOPS),
            ("line_bound", D2_LINE_FLOPS["sample"] * samples
             + D2_LINE_FLOPS["line"] * line_planes, FP32_FLOPS),
            ("general_floor", PARITY_OPS["d2_general"] * samples,
             FP32_FLOPS / 2),
            ("line_floor", PARITY_OPS["d2_line"]["sample"] * samples
             + PARITY_OPS["d2_line"]["line"] * line_planes,
             FP32_FLOPS / 2)):
        to = ops / rate
        d_times[f"d2_{label}_ms"] = max(tb, to) * 1e3
        d_times[f"d2_{label}_by"] = "bytes" if tb >= to else "operations"
    d_times["d2_samples"] = samples
    d_times["d2_line_planes"] = line_planes
    # grid_sample, trilinear with zero padding, of each slab at every
    # voxel of each tilt, then summed over the projection axis: timed
    # only, a shard at a time (41 grids of 250^3 points)
    for i in range(SHARDS):
        grids = []
        for m in rms:
            c = vt.ops.affine_coords(big, m, device=dev)
            grids.append(torch.stack(
                [c[2] * (2.0 / (SIZE - 1)) - 1.0,
                 c[1] * (2.0 / (SIZE - 1)) - 1.0,
                 (c[0] - offs[i]) * (2.0 / (local - 1)) - 1.0], -1)[None])
            del c
        library_ms += time_ms(torch, lambda: [grid_sample(
            xs[i][None, None], g, mode="bilinear", padding_mode="zeros",
            align_corners=True).sum(dim=2) for g in grids], reps=2,
            warmup=1)
        del grids
    d_times["d2_grid_sample_sum_ms"] = library_ms
    del xs, xs_full
    st.update(d_times)

    emit("sharded", shape=list(big), shards=SHARDS,
         mesh=[str(d) for d in mesh.devices], local_planes=-(-SIZE // SHARDS),
         launches=shard_launches, launches_by_entry=shard_entries,
         check_seconds=check_seconds,
         volume_calls=rows, max_abs_err_by_body=worst_sharded,
         two_shard_prefilter_max_abs_err=prefilter_err,
         two_shard_affine_max_abs_err=two_shard_err,
         make_mesh={"devices": [str(d) for d in make_mesh().devices],
                    "body": body1, "max_abs_err_vs_single": make_mesh_err,
                    "equal_to_single": make_mesh_equal},
         batch_calls=batch_rows, recon_rel_err_vs_single=recon_rows,
         recon_equal_to_plain_adjoint=recon_equal,
         recon_rtol=RECON_RTOL, sirt_iterations=SHARD_SIRT_ITERATIONS,
         overflows=S.overflows(dev),
         atol={"halo_gather": SHARD_ATOL, "stream": SHARD_STREAM_ATOL,
               "prefilter": SHARD_PREFILTER_ATOL},
         times=st, method="CUDA events after warm-up; memory by "
         "max_memory_allocated after reset_peak_memory_stats, above what "
         "was allocated before the call, the result included")

    # --------------------------------------------------- 11. examples
    import contextlib
    import importlib.util
    import io

    def run_example(name):
        """examples/torch_<name>.py's ``main`` on 'cuda' at its own size,
        with the launches per kernel (the counters set to 0 just before,
        read just after), the host seconds of the call and the lines it
        printed (kept off this script's standard output, which holds
        JSON lines)."""
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples", f"torch_{name}.py")
        spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        torch.cuda.synchronize()
        zero_launches()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            result = module.main(device="cuda", figure=None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        result["printed"] = printed.getvalue().splitlines()
        return module, result, launches, seconds

    example_rows = {}
    example_launches = dict.fromkeys(launch_counts(), 0)

    def record(name, launches, expected, seconds, **fields):
        assert launches == expected, (name, launches, expected)
        for k in example_launches:
            example_launches[k] += launches[k]
        example_rows[name] = dict(launches=launches,
                                  expected_launches=expected,
                                  seconds=seconds, **fields)

    def resampled_vs_plain(name, got, volume, m, prefilter=False):
        """A host volume that one resampling launch made, against the
        plain sampler on the card on the same input (after the same
        prefilter): ATOL off knife edges, as on the main path."""
        vol = torch.from_numpy(volume).to(dev)
        if prefilter:
            vol = bspline_prefilter(vol)
        want = affine_sample(vol, torch.as_tensor(m, dtype=torch.float32,
                                                  device=dev),
                             interp_of[3 if prefilter else 1],
                             prefiltered=True)
        got = torch.from_numpy(got).to(dev)
        off, every = errors(torch, got, want, m)
        assert off <= ATOL, (name, "against the plain sampler", off)
        return {"max_abs_err": off, "max_abs_err_all_voxels": every,
                "equal": bool(torch.equal(got, want)), "atol": ATOL}

    def projections_vs_plain(name, got, volume, ms):
        """A projector's host series against ``plain_project_stack`` on the
        card (one plain resampling a tilt, then the sum over axis 0)."""
        want = plain_project_stack(torch.from_numpy(volume).to(dev), ms,
                                   "linear", "constant", 0).cpu().numpy()
        tol = example_sum_atol(volume.shape[0], float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        assert err <= tol, (name, "against plain_project_stack", err, tol)
        return {"max_abs_err": err, "equal": bool(np.array_equal(got, want)),
                "atol": tol}

    # transformation: the prefilter, then one resampling launch a pass
    ex, res, launches, seconds = run_example("transformation")
    eshape = res["volume"].shape
    off, every = errors(torch, torch.from_numpy(res["device"]),
                        torch.from_numpy(res["scipy"]), res["matrix"])
    assert off <= SCIPY_ATOL, ("transformation against scipy", off)
    plain = resampled_vs_plain("transformation", res["device"],
                               res["volume"], res["matrix"], prefilter=True)
    record("transformation", launches,
           planned([(res["matrix"], eshape, 3)] * res["passes"]), seconds,
           shape=list(eshape), interpolation=ex.INTERPOLATION,
           max_abs_err_vs_scipy=off, max_abs_err_vs_scipy_all_voxels=every,
           atol=SCIPY_ATOL, vs_plain=plain, scipy_host_ms=res["scipy_ms"],
           device_ms=res["device_ms"], device_name=res["card"],
           printed=res["printed"])

    # projections: 41 one-shot calls and 41 StaticVolume calls (one matrix
    # each), then the projector's launches, each pass
    ex, res, launches, seconds = run_example("projections")
    eshape = res["volume"].shape
    ecenter = np.divide(np.subtract(eshape, 1), 2)
    singles = [transform_matrix(rotation=(0.0, a, 0.0),
                                rotation_order=ex.ROTATION_ORDER,
                                center=ecenter) for a in ex.ANGLES]
    one_pass = ([(m, eshape, 1) for m in singles] * 2
                + [(c, eshape, 1)
                   for c in chunks_of(res["matrices"], eshape)])
    levels = {k: res[k] for k in ("one_shot", "static_volume", "projector")}
    sum_tol = example_sum_atol(eshape[0], max(float(np.abs(v).max())
                                              for v in levels.values()))
    agreement = {f"{a}_vs_{b}": float(np.abs(levels[a] - levels[b]).max())
                 for a, b in (("one_shot", "static_volume"),
                              ("one_shot", "projector"),
                              ("static_volume", "projector"))}
    assert max(agreement.values()) <= sum_tol, (agreement, sum_tol)
    plain = projections_vs_plain("projections", res["projector"],
                                 res["volume"], res["matrices"])
    n_tilts = len(ex.ANGLES)
    record("projections", launches, planned(one_pass * res["passes"]),
           seconds, shape=list(eshape), tilts=n_tilts,
           rotation_order=ex.ROTATION_ORDER, tilt_axis=ex.TILT_AXIS,
           max_abs_diff_between_levels=agreement, atol=sum_tol,
           projector_vs_plain=plain, ms=res["ms"],
           ms_per_tilt={k: v / n_tilts for k, v in res["ms"].items()},
           one_shot_note="each rotated volume is copied to the host and "
           "summed there, as the JAX example does",
           device_name=res["card"], printed=res["printed"])
    del levels

    # reconstruction: the projection, SIRT's row sums and one forward
    # sweep an iteration; C once a WBP, then SIRT's column sums and once
    # an iteration
    ex, res, launches, seconds = run_example("reconstruction")
    eshape = res["volume"].shape
    sweeps = 2 + res["iterations"]
    expected = planned([(c, eshape, 1)
                        for c in chunks_of(res["matrices"], eshape)]
                       * sweeps * res["passes"],
                       back_projections=sweeps * res["passes"])
    projections = projections_vs_plain("reconstruction", res["projections"],
                                       res["volume"], res["matrices"])
    equal = {
        "wbp": np.array_equal(res["wbp"], wbp_reconstruct(
            res["projections"], res["matrices"], eshape, device="cuda",
            _plain_adjoint=True)),
        "sirt": np.array_equal(res["sirt"], sirt_reconstruct(
            res["projections"], res["matrices"], eshape,
            iterations=res["iterations"], device="cuda",
            _plain_adjoint=True))}
    assert all(equal.values()), ("with C != with its plain version", equal)
    corr = res["interior_correlation"]
    corr_diff = {k: abs(corr[k] - JAX_RECON_CORRELATION[k])
                 for k in JAX_RECON_CORRELATION}
    assert max(corr_diff.values()) <= EXAMPLE_CORR_ATOL, (corr, corr_diff)
    record("reconstruction", launches, expected, seconds, shape=list(eshape),
           tilts=len(res["angles"]), iterations=res["iterations"],
           projections_vs_plain=projections, equal_to_plain_adjoint=equal,
           interior_correlation=corr,
           jax_interior_correlation=JAX_RECON_CORRELATION,
           correlation_atol=EXAMPLE_CORR_ATOL, ms=res["ms"],
           project_ms_per_tilt=res["ms"]["project"] / len(res["angles"]),
           sirt_ms_per_iteration=res["ms"]["sirt"] / res["iterations"],
           project_note="the projections are copied to the host, as the "
           "JAX example returns them",
           device_name=res["card"], printed=res["printed"])

    # registration: the moving volume (once), then RegistrationResult.apply
    # each pass; a single matrix routes to A whatever its values, so the
    # first pass's matrix routes as the last pass's
    ex, res, launches, seconds = run_example("registration")
    eshape = res["reference"].shape
    deg_tol = 0.3 * 24 / eshape[0]
    assert np.isfinite(res["loss_history"]).all()
    assert (res["rotation_error_deg"] <= deg_tol
            and res["translation_error_vox"] <= REG_T_TOL), (
        res["rotation_error_deg"], res["translation_error_vox"], deg_tol)
    assert res["misfit"]["after"] < res["misfit"]["before"], res["misfit"]
    plain = {"misaligned": resampled_vs_plain(
                 "registration's moving volume", res["misaligned"],
                 res["reference"], res["m_true"]),
             "registered": resampled_vs_plain(
                 "RegistrationResult.apply", res["registered"],
                 res["moving"], res["matrix"])}
    record("registration", launches,
           planned([(res["m_true"], eshape, 1)]
                   + [(res["matrix"], eshape, 1)] * res["passes"]),
           seconds, shape=list(eshape), steps=len(res["loss_history"]),
           w=res["w"].tolist(), t=res["t"].tolist(),
           w_expect=res["w_expect"].tolist(),
           t_expect=res["t_expect"].tolist(),
           rotation_error_deg=res["rotation_error_deg"],
           translation_error_vox=res["translation_error_vox"],
           bounds={"rotation_deg": deg_tol, "translation_vox": REG_T_TOL},
           phase_correlation_shift=res["phase_correlation_shift"].tolist(),
           misfit=res["misfit"], vs_plain=plain, ms=res["ms"],
           register_ms_per_step=res["ms"]["register"]
           / len(res["loss_history"]), device_name=res["card"],
           printed=res["printed"])
    del res
    # every kernel runs in one example at least
    assert all(example_launches[k] > 0 for k in ABC), example_launches
    emit("examples", launches=example_launches, examples=example_rows,
         method="each example's main(device='cuda', figure=None) at its "
         "own size; it runs its pipeline twice and times the second pass "
         "on the host clock read after torch.cuda.synchronize(); its "
         "launches, both passes', against the planner's for each")

    main_tilt = {k: main_launches[k] + tilt_launches[k] + reg_launches[k]
                 + shard_launches[k] + example_launches[k]
                 for k in main_launches}
    kernels = [{
        "name": S.NAME, "route": "cuda", "source": S.SOURCE,
        "replaces": S.REPLACES, "launches": main_tilt[S.NAME],
        "launches_by_path": {"main": main_launches[S.NAME],
                             "tilt": tilt_launches[S.NAME],
                             "registration": reg_launches[S.NAME],
                             "sharded": shard_launches[S.NAME],
                             "examples": example_launches[S.NAME]},
        "max_abs_err": max(slab_worst[1], slab_worst[3]),
        "ms": t["recon_tilt_linear_batch_slab_ms_per_matrix"],
        "plain_ms": t["recon_tilt_linear_plain_ms"],
        "bound_ms": t["recon_tilt_linear_batch_bound_ms_per_matrix"],
        "bound_by": t["recon_tilt_linear_batch_bound_by"],
        "library_ms": t["recon_tilt_grid_sample_trilinear_ms"],
        "shape": list(big), "matrices": "the reconstruction's 41-tilt "
        "series, linear, in one launch, per matrix (the launches it takes)",
        "max_abs_err_all_voxels": slab_worst_all,
        "equal_to_walk": True, "overflows": S.overflows(dev),
        "walk_same_matrices_ms":
            t["recon_tilt_linear_batch_walk_ms_per_matrix"],
        "rows_ms_per_tilt": {k: v["rows_ms_per_tilt"]
                             for k, v in rows_times.items()},
        "rows_general_ms_per_tilt": {k: v["general_ms_per_tilt"]
                                     for k, v in rows_times.items()},
        "rows_least_ms_per_tilt": {k: v["least_ms_per_tilt"]
                                   for k, v in rows_times.items()},
        "single_ms": t["tilt_linear_slab_ms"],
        "single_bound_ms": t["tilt_linear_bound_ms"],
        "walk_single_same_matrices_ms": t["tilt_linear_walk_same_ms"],
        "cubic": {"ms": t["tilt_cubic_slab_ms"],
                  "plain_ms": t["tilt_cubic_plain_ms"],
                  "bound_ms": t["tilt_cubic_bound_ms"],
                  "bound_by": t["tilt_cubic_bound_by"], "library_ms": None,
                  "walk_same_matrices_ms": t["tilt_cubic_walk_same_ms"],
                  "batch_ms_per_matrix":
                      t["tilt_cubic_batch_slab_ms_per_matrix"],
                  "max_abs_err": slab_worst[3]},
    }, {
        "name": K.NAME, "route": "cuda", "source": K.SOURCE,
        "replaces": K.REPLACES, "launches": main_tilt[K.NAME],
        "launches_by_path": {"main": main_launches[K.NAME],
                             "tilt": tilt_launches[K.NAME],
                             "registration": reg_launches[K.NAME],
                             "sharded": shard_launches[K.NAME],
                             "examples": example_launches[K.NAME]},
        "max_abs_err": max(worst[1], worst[3], main_err[1], main_err[3]),
        "ms": t["random_linear_walk_ms"],
        "plain_ms": t["random_linear_plain_ms"],
        "bound_ms": t["random_linear_walk_bound_ms"],
        "bound_by": t["random_linear_walk_bound_by"],
        "library_ms": t["random_grid_sample_trilinear_ms"],
        "shape": list(big), "matrices": "16 random 'sxyz' rotations, "
        "linear, one per launch", "max_abs_err_all_voxels": worst_all,
        "equal_to_plain": True,
        "tilt_ms": t["tilt_linear_walk_ms"],
        "batch_ms_per_matrix": t["random_linear_batch_walk_ms_per_matrix"],
        "batch_bound_ms_per_matrix":
            t["random_linear_batch_bound_ms_per_matrix"],
        "cubic": {"ms": t["random_cubic_walk_ms"],
                  "tilt_ms": t["tilt_cubic_walk_ms"],
                  "fast_path_share": t["random_cubic_walk_fast_path_share"],
                  "plain_ms": t["random_cubic_plain_ms"],
                  "bound_ms": t["random_cubic_walk_bound_ms"],
                  "bound_by": t["random_cubic_walk_bound_by"],
                  "library_ms": None,
                  "batch_ms_per_matrix":
                      t["random_cubic_batch_walk_ms_per_matrix"],
                  "max_abs_err": max(worst[3], main_err[3])},
    }, {
        "name": BP.NAME, "route": "cuda", "source": BP.SOURCE,
        "replaces": BP.REPLACES, "launches": main_tilt[BP.NAME],
        "launches_by_path": {"main": main_launches[BP.NAME],
                             "tilt": tilt_launches[BP.NAME],
                             "registration": reg_launches[BP.NAME],
                             "sharded": shard_launches[BP.NAME],
                             "examples": example_launches[BP.NAME]},
        "max_abs_err": bp_worst,
        "ms": t["backproject_rowgather_ms"],
        "plain_ms": t["backproject_rowgather_plain_ms"],
        "bound_ms": t["backproject_rowgather_bound_ms"],
        "bound_by": t["backproject_rowgather_bound_by"],
        "library_ms": t["backproject_grid_sample_sum_ms"],
        "baseline_ms": t["backproject_rowgather_baseline_ms"],
        "window_misses": bp_misses + t["backproject_window_misses"],
        "shape": list(big), "matrices": "the reconstruction's 41-tilt "
        "series, projection axis 0, row-gather path, one launch",
        "equal_to_plain": True,
        "library_max_abs_diff":
            t["backproject_grid_sample_sum_max_abs_diff"],
        "general": {"ms": t["backproject_general_ms"],
                    "plain_ms": t["backproject_general_plain_ms"],
                    "bound_ms": t["backproject_general_bound_ms"],
                    "bound_by": t["backproject_general_bound_by"],
                    "library_ms": None},
        "tomogram": {"shape": list(TOMO_SHAPE),
                     "ms": t["tomogram_backproject_ms"],
                     "baseline_ms": t["tomogram_backproject_baseline_ms"],
                     "bound_ms": t["tomogram_backproject_bound_ms"],
                     "bound_by": t["tomogram_backproject_bound_by"],
                     "wbp_ms": t["tomogram_wbp_ms"],
                     "wbp_plain_adjoint_ms":
                         t["tomogram_wbp_plain_adjoint_ms"]},
    }]

    def by_path(name):
        return {"main": main_launches[name], "tilt": tilt_launches[name],
                "registration": reg_launches[name],
                "sharded": shard_launches[name],
                "examples": example_launches[name]}
    assert main_tilt[MU.NAME] == 0, main_tilt
    assert main_tilt[MU.NOISE_NAME] == 0, main_tilt
    assert main_tilt[ZP.NAME] == 0, main_tilt
    assert main_tilt[MS.NAME] == main_tilt[MS.FINISH_NAME] == 0, main_tilt
    kernels += [{
        "name": D1, "route": "cuda", "source": PS.SOURCE,
        "replaces": PS.REPLACES[D1], "launches": main_tilt[D1],
        "launches_by_path": by_path(D1),
        "launches_by_entry": {"ring": shard_entries["d1_ring"],
                              "per_step": shard_entries["d1_step"]},
        "max_abs_err": d1_worst,
        "ms": st["d1_linear_kernel_ms"], "plain_ms": st["d1_linear_plain_ms"],
        "bound_ms": st["d1_linear_bound_ms"],
        "bound_by": st["d1_linear_bound_by"],
        "library_ms": st["d1_grid_sample_ms"],
        "shape": list(big), "matrices": "one random rotation through the "
        "stream body on 4 shards, linear: the device time of its 4 ring "
        "launches (events around each, the call queued behind a sleep "
        "kernel); body_ms the stream body's call; per_step_ms the 16 "
        "launches of the per-step entry over the same rings, baseline_ms "
        "those of D before its redesign, in the same rounds; bound_ms the "
        "function's, per_step_bound_ms the per-step design's, floor_ms "
        "that of a design that keeps bit parity; the plain version the "
        "stream body with plain=True",
        "equal_to_plain": True, "body_ms": st["d1_linear_body_ms"],
        "per_step_ms": st["d1_linear_per_step_ms"],
        "baseline_ms": st["d1_linear_baseline_ms"],
        "per_step_bound_ms": st["d1_linear_per_step_bound_ms"],
        "floor_ms": st["d1_linear_floor_ms"],
        "cubic": {"ms": st["d1_cubic_kernel_ms"],
                  "plain_ms": st["d1_cubic_plain_ms"],
                  "bound_ms": st["d1_cubic_bound_ms"],
                  "bound_by": st["d1_cubic_bound_by"], "library_ms": None,
                  "body_ms": st["d1_cubic_body_ms"],
                  "per_step_ms": st["d1_cubic_per_step_ms"],
                  "baseline_ms": st["d1_cubic_baseline_ms"],
                  "per_step_bound_ms": st["d1_cubic_per_step_bound_ms"],
                  "floor_ms": st["d1_cubic_floor_ms"]},
    }, {
        "name": D2, "route": "cuda", "source": PS.SOURCE,
        "replaces": PS.REPLACES[D2], "launches": main_tilt[D2],
        "launches_by_path": by_path(D2),
        "line_launches": shard_entries["d2_line"],
        "max_abs_err": d2_worst,
        "ms": st["d2_kernel_ms"], "plain_ms": st["d2_plain_ms"],
        "bound_ms": st["d2_line_bound_ms"],
        "bound_by": st["d2_line_bound_by"],
        "library_ms": st["d2_grid_sample_sum_ms"],
        "shape": list(big), "matrices": "the reconstruction's 41-tilt "
        "series, projection axis 0: one sweep, a launch for each of 4 "
        "shards on the line path, the device time of the 4 launches "
        "(events around each, the sweep queued behind a sleep kernel); "
        "general_ms the general kernel's (_force_general), baseline_ms "
        "D's before its redesign, in the same rounds; bound_ms the line "
        "geometry's (a bilinear sample), general_bound_ms a trilinear "
        "sample's, the floors those of designs that keep bit parity; "
        "sweep_ms the sweep's call",
        "sweep_ms": st["d2_sweep_ms"],
        "general_ms": st["d2_general_ms"],
        "baseline_ms": st["d2_baseline_ms"],
        "general_bound_ms": st["d2_bound_ms"],
        "floor_ms": st["d2_line_floor_ms"],
        "general_floor_ms": st["d2_general_floor_ms"],
        "tolerance": "sum_order_atol: two orders of a float32 sum; the "
        "line path equal to the general kernel",
    }, {
        "name": MU.NAME, "route": "cuda", "source": MU.SOURCE,
        "replaces": "no TPU kernel (the JAX package has no template "
        "matching): TemplateMatcher's four torch kernels of the update",
        "launches": match_path["launches"],
        "launches_by_path": dict(by_path(MU.NAME),
                                 match=match_path["launches"]),
        "max_abs_err": max(match_times["max_abs_err"],
                           match_path["max_abs_err"]),
        "max_bit_diff": max(match_times["max_bit_diff"],
                            match_path["max_bit_diff"]),
        "index_mismatch": max(match_times["index_mismatch"],
                              match_path["index_mismatch"]),
        "ms": match_times["late_ms"], "first_ms": match_times["first_ms"],
        "plain_ms": match_times["plain_ms"],
        "bound_ms": match_times["bound_ms"], "bound_by": "bytes",
        "bound_all_written_ms": match_times["bound_all_written_ms"],
        "late_improved_share": match_times["late_improved_share"],
        "library_ms": None, "shape": match_times["shape"],
        "matrices": "none: a sweep of fresh correlations from a reset, ms "
        "the last quarter's mean a launch; launches those of one "
        f"TemplateMatcher.match call of {MATCH_CALL} orientations at the "
        "tomogram's shape (phase 4f); the errors the largest of phases 4e "
        "and 4f (score_diff)",
        "tolerance": "bit for bit (the scores' bit patterns)",
    }, {
        "name": ZP.NAME, "route": "cuda", "source": ZP.SOURCE,
        "replaces": "no TPU kernel (the JAX package has no template "
        "matching): the correlation's whole-grid forward pass, the "
        "product with the spectrum (two under a rotated mask) and the "
        "inverse's pass along z, in TemplateMatcher",
        "launches": match_path["zpass_launches"]["match"],
        "launches_by_path": dict(by_path(ZP.NAME),
                                 **match_path["zpass_launches"]),
        "max_abs_err": None,
        "max_rel_err": {k: zpass_times[k]["max_rel_err"]
                        for k in ("complex64", "complex128")},
        "ms": zpass_times["complex64"]["ms"],
        "plain_ms": zpass_times["complex64"]["plain_ms"],
        "bound_ms": zpass_times["complex64"]["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "complex128": zpass_times["complex128"],
        "kernel_against_plain": match_path["kernel_against_plain"],
        "depth_180": zpass_times[f"depth {MATCH_ODD_DEPTH}"],
        "bin_4": zpass_times["bin 4"],
        "launches_random_phase": {
            k: v["launches"][ZP.NAME] for k, v in rpc_path["cases"].items()},
        "shape": zpass_times["shape"],
        "matrices": "none: 48 random planes and random spectra at tm512's "
        "shapes, ms a launch (complex64, one spectrum; complex128 the "
        "sigma's two); launches those of one TemplateMatcher.match call of "
        f"{MATCH_CALL} orientations under a spherical mask (match) and an "
        "ellipsoidal one (match_nsmask), phase 4f",
        "tolerance": "10 units of the last place times log2 N of the "
        "largest |plain|: two FFTs' rounding",
    }, {
        "name": MU.NOISE_NAME, "route": "cuda", "source": MU.SOURCE,
        "replaces": "no TPU kernel (the JAX package has no template "
        "matching): the random-phase correction's running maximum of the "
        "noise template's scores, torch's mul and maximum",
        "launches": rpc_path["launches"],
        "launches_by_path": dict(
            by_path(MU.NOISE_NAME), match=match_path["noise_launches"],
            **{f"match_random_phase {k}": v["launches"][MU.NOISE_NAME]
               for k, v in rpc_path["cases"].items()}),
        "max_abs_err": max(noise_times["max_abs_err"],
                           rpc_path["max_abs_err"]),
        "max_bit_diff": max(noise_times["max_bit_diff"],
                            rpc_path["max_bit_diff"]),
        "kernel_against_plain": {k: v["kernel_against_plain"]
                                 for k, v in rpc_path["cases"].items()},
        "ms": noise_times["late_ms"], "first_ms": noise_times["first_ms"],
        "plain_ms": noise_times["plain_ms"],
        "bound_ms": noise_times["bound_ms"], "bound_by": "bytes",
        "bound_all_written_ms": noise_times["bound_all_written_ms"],
        "library_ms": None, "shape": noise_times["shape"],
        "matrices": "none: a sweep of fresh correlations from a reset, ms "
        "the last quarter's mean a launch; launches those of one "
        f"TemplateMatcher.match call of {MATCH_CALL} orientations with "
        "random_phase_correction at tm512's shapes under a spherical mask "
        "(phase 4f); the errors the largest of phases 4e and 4f "
        "(score_diff)",
        "tolerance": "bit for bit (the scores' bit patterns)",
    }, {
        "name": MS.NAME, "route": "cuda", "source": MS.SOURCE,
        "replaces": "no TPU kernel (the JAX package has no template "
        "matching): under a rotated mask, torch's C2R along x of the two "
        "moments and the map's plain passes (the scale, addcmul_, the "
        "float32 copy, the maximum, the floor's compare, rsqrt_, "
        "masked_fill_), in TemplateMatcher",
        "launches": match_path["sigma_launches"]["match_nsmask"][MS.NAME],
        "finish_launches":
            match_path["sigma_launches"]["match_nsmask"][MS.FINISH_NAME],
        "launches_by_path": dict(
            {k: v + by_path(MS.FINISH_NAME)[k]
             for k, v in by_path(MS.NAME).items()},
            **match_path["sigma_launches"]),
        "max_abs_err": None, "max_rel_err": sigma_times["max_rel_err"],
        "floored_one_side": sigma_times["floored_one_side"],
        "maps_against_plain": sigma_times["maps"],
        "other_designs": sigma_times["other_designs"],
        "ms": sigma_times["ms"], "bound_ms": sigma_times["bound_ms"],
        "bound_by": "bytes", "finish_ms": sigma_times["finish_ms"],
        "finish_bound_ms": sigma_times["finish_bound_ms"],
        "plain_ms": sigma_times["plain_ms"],
        "y_pass_ms": sigma_times["y_pass_ms"],
        "tail_before_ms": sigma_times["tail_before_ms"],
        "tail_after_ms": sigma_times["tail_after_ms"],
        "library_ms": None, "shape": sigma_times["shape"],
        "matrices": "none: one orientation's moments under tm512-nsmask's "
        "ellipsoid, ms the first entry's launch and finish_ms the "
        "finish's; launches and finish_launches each entry's in one "
        f"TemplateMatcher.match call of {MATCH_CALL} orientations under "
        "an ellipsoidal mask (phase 4f; launches_by_path's match_nsmask), "
        "none in the same call under a spherical one (match); "
        "other_designs the shared-memory design's widths against the "
        "plain version",
        "tolerance": "8 units of 2^-24 of each voxel's plain value: w's "
        "float64 rounding in another order of the row's transform and "
        "rsqrt's last place",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
