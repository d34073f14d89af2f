"""Several devices: sharded volumes and data-parallel transform batches.

The port's counterpart of ``voltools_tpu/parallel/sharded.py``.  The JAX
package runs its bodies under ``shard_map`` on a ``jax.sharding.Mesh``: one
Python process drives every device (single controller).  The port keeps
that model with no process group: a :class:`Mesh` is an ordered tuple of
``torch.device``s, each body is a Python loop over the shards, and the three
collectives it needs are small functions here:

* :func:`_ring_shift`, the counterpart of ``ppermute``: a tensor copied to
  the next shard's device without blocking the host.  On a repeated device
  it is the same tensor, so no body writes into a received tensor.
* :func:`_all_gather`, the counterpart of ``all_gather(tiled=True)``: the
  shards copied in z order into one pitched volume on the receiving
  device, at most once per distinct device and call.
* :func:`_psum`: the partials summed in the order of the shards, the sum
  handed to each shard's device.

A device may repeat in a mesh, so several shards can live on one card:
``Mesh(['cuda:0'] * 4)`` runs every collective path of a 4-device mesh on
one GPU, as the JAX tests run theirs on 8 host devices; a process group
could not (NCCL takes one rank per device).

* :class:`ShardedVolume` -- a volume sharded along axis 0.  Local
  transforms (every source point within a bounded halo of its own slab)
  exchange a halo and resample the extended slab; global ones either
  stream the source slabs around the ring and sum per-tap partial samples
  (``'stream'``, the default: no array of the full volume's size exists
  on any device), or gather the volume on each device first
  (``'gather'``).  The halo and gather bodies launch the planner's CUDA
  kernel per shard (:func:`..transforms._resample`), the plain version on
  the CPU; the stream body launches the kernel D1, where the JAX package
  leaves the ring's samples to XLA: once per shard over its whole ring
  where the ring's slabs already lie on the shard's device
  (:func:`..kernels.partial_sample.partial_sample_ring`), else once per
  shard and slab as they come round
  (:func:`..kernels.partial_sample.partial_sample`).
* :func:`sharded_affine_batch` -- N matrices applied data-parallel: the
  volume is replicated once per distinct device and each shard resamples
  its share of the matrices in one launch.

Host values that the JAX bodies form in float32 on the device (the slab
shift of a matrix) are formed in float32 on the host here, one exact
float32 step each, never through a float64 product.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.layout import pitched, pitched_empty
from ..kernels.partial_sample import (RING_CAPACITY, partial_sample,
                                      partial_sample_ring,
                                      plain_partial_step, sample_frame)
from ..ops.interpolation import (AVAILABLE_INTERPOLATIONS, MODES,
                                 needs_prefilter, spline_order)
from ..ops.prefilter import (_FIR_HALF_WIDTH, POLE, bspline_prefilter,
                             prefilter_fir)
from ..transforms import (_as_tensor, _as_triple, _check_shape, _finish,
                          _resample)
from ..utils import resolve_device, rotation_matrix, transform_matrix


class Mesh:
    """A 1-D device mesh: an ordered tuple of ``torch.device``s, one per
    shard (the counterpart of a 1-D ``jax.sharding.Mesh``).  A device may
    repeat: its shards then share it.  All devices are of one type."""

    def __init__(self, devices: Sequence, axis_name: str = "shard"):
        devices = tuple(resolve_device(str(torch.device(d)))
                        for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(
                f"a mesh's devices are all CUDA or all CPU, got {devices}")
        self.devices = devices
        self.axis_names = (axis_name,)

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)

    @property
    def distinct(self):
        """The mesh's devices without repeats, in order of first use."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names[0]!r})"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "shard",
              device: str = "cuda") -> Mesh:
    """A 1-D mesh (``voltools_tpu/parallel/sharded.py:42-50``).

    ``device='cuda'``: over the first ``n_devices`` CUDA devices (default
    all of them); fewer devices, or none, raise.  ``device='cpu'``:
    ``n_devices`` shards (default 1) on the CPU."""
    if device == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"n_devices must be at least 1, got {n}")
        return Mesh(["cpu"] * n, axis_name)
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else int(n_devices)
    if count == 0 or not 1 <= n <= count:
        raise ValueError(
            f"a mesh of {n_devices} CUDA devices needs them, {count} "
            f"present; use device='cpu' for a mesh on the CPU")
    return Mesh([f"cuda:{i}" for i in range(n)], axis_name)


# ------------------------------------------------------------ collectives

def _ring_shift(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: a copy in stream order across devices, ``t``
    itself on its own device (``ppermute``)."""
    return t.to(device, non_blocking=True)


def _all_gather(shards, device: torch.device) -> torch.Tensor:
    """The shards, in z order, as one pitched volume on ``device``
    (``all_gather(tiled=True)``)."""
    local = shards[0].shape[0]
    full = pitched_empty((local * len(shards),) + tuple(shards[0].shape[1:]),
                         device=device)
    for i, s in enumerate(shards):
        full[i * local:(i + 1) * local].copy_(s, non_blocking=True)
    return full


def _psum(partials, devices) -> dict:
    """The sum of ``partials`` in their order, handed to each of
    ``devices``: ``{device: sum}``, one tensor per distinct device
    (``psum``)."""
    total = partials[0]
    for p in partials[1:]:
        total = total + _ring_shift(p, total.device)
    return {d: _ring_shift(total, d) for d in dict.fromkeys(devices)}


# ---------------------------------------------------------------- helpers

def halo_for_matrix(shape, matrix, interpolation: str = "linear") -> Optional[int]:
    """Voxels of axis-0 halo needed so each output slab can be computed from
    its own source slab.  None when the transform is non-local (needs the
    full volume, e.g. large rotations).  (``sharded.py:74-90``, verbatim.)"""
    m = np.asarray(matrix, dtype=np.float64)
    d0, d1, d2 = shape
    # max |src_z - out_z| over the output domain: linear function maximised
    # at the corners of the index box
    corners = np.array([[z, y, x, 1.0] for z in (0, d0 - 1)
                        for y in (0, d1 - 1) for x in (0, d2 - 1)]).T
    src_z = (m[0] @ corners)
    disp = np.abs(src_z - corners[0]).max()
    apron = 1 if interpolation == "linear" else 2
    halo = int(np.ceil(disp)) + apron
    if halo >= d0:
        return None
    return halo


def _shifted(matrix: np.ndarray, start: np.float32) -> np.ndarray:
    """``matrix`` with the output shifted by ``start`` planes along z:
    column 3 plus column 0 times ``start``, one float32 step
    (``matrix.at[:, 3].add(matrix[:, 0] * start)``)."""
    m = matrix.copy()
    m[..., :, 3] += matrix[..., :, 0] * start
    return m


def _pad_planes(vol: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """``vol`` followed by ``pad`` planes of its mode's extension (zeros
    for 'border', scipy's mirror: plane d0 + k reads plane d0 - 2 - k), as
    a new tensor."""
    if not pad:
        return vol
    if mode == "border":
        ext = vol.new_zeros((pad,) + tuple(vol.shape[1:]))
    else:
        ext = torch.flip(vol[-pad - 1:-1], (0,))
    return torch.cat([vol, ext])


def _exchange_halo(shards, i: int, halo: int, edge: str) -> torch.Tensor:
    """Shard ``i`` extended by ``halo`` planes on each side, in one pitched
    buffer on its device (``sharded.py:93-116``): the neighbours' planes
    across the ring, and at the two global edges the extension a
    single-device sampler would see, ``'zero'`` (mode 'border') or
    ``'mirror'`` (scipy 'constant' and the prefilter's FIR).  The ring's
    wrapped planes would be replaced at the edges, so they are not sent."""
    n = len(shards)
    s = shards[i]
    local = s.shape[0]
    ext = pitched_empty((local + 2 * halo,) + tuple(s.shape[1:]),
                        device=s.device)
    below, mid, above = (ext[:halo], ext[halo:halo + local],
                         ext[halo + local:])
    mid.copy_(s)
    if i > 0:
        below.copy_(_ring_shift(shards[i - 1][-halo:], s.device))
    elif edge == "zero":
        below.zero_()
    else:
        below.copy_(torch.flip(s[1:halo + 1], (0,)))
    if i < n - 1:
        above.copy_(_ring_shift(shards[i + 1][:halo], s.device))
    elif edge == "zero":
        above.zero_()
    else:
        above.copy_(torch.flip(s[-halo - 1:-1], (0,)))
    return ext


def _z_inside(m: np.ndarray, out_shape, d0: int, mode: str,
              device) -> torch.Tensor:
    """Whether each output voxel's source z lies inside the TRUE extent
    ``d0`` by ``mode``'s test, from row 0 of ``m`` in float32, in the
    order of :func:`..ops.sampling.affine_coords`."""
    d, h, w = out_shape
    z = torch.arange(d, dtype=torch.float32, device=device).view(d, 1, 1)
    y = torch.arange(h, dtype=torch.float32, device=device).view(1, h, 1)
    x = torch.arange(w, dtype=torch.float32, device=device).view(1, 1, w)
    r = [float(v) for v in m[0]]
    zsrc = r[0] * z + r[1] * y + r[2] * x + r[3]
    if mode == "border":
        return (zsrc > -0.5) & (zsrc < d0 - 0.5)
    return (zsrc >= 0) & (zsrc <= d0 - 1)


def _float32(data) -> torch.Tensor:
    """``data`` as a float32 tensor: a tensor on its device, a numpy array
    on the CPU."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.float32)
    return _as_tensor(data, torch.device("cpu"))


def _check_output(output):
    if output is None or isinstance(output, np.ndarray):
        return
    if isinstance(output, str) and output == "device":
        return
    raise ValueError(
        "output must be None, a numpy array to fill, or 'device' for the "
        f"per-shard tensors; got {output!r}")


def _crop(slabs, d0: int):
    """The per-shard slabs of a padded z extent cropped to ``[0, d0)``:
    shards wholly in the pad are dropped, the last one kept is cut."""
    out, start = [], 0
    for s in slabs:
        if start >= d0:
            break
        out.append(s[:d0 - start] if start + s.shape[0] > d0 else s)
        start += s.shape[0]
    return tuple(out)


def _host(slabs) -> np.ndarray:
    """Per-shard tensors concatenated along axis 0 on the host."""
    return np.concatenate([s.cpu().numpy() for s in slabs])


# ------------------------------------------------------------ the volume

class ShardedVolume:
    """A volume sharded along axis 0 across a :class:`Mesh`
    (``sharded.py:208-599``).

    Parameters mirror :class:`voltools_tpu_torch.StaticVolume`; the volume
    is prefiltered once (shard-wise where the slabs are thick enough) for
    ``filt_bspline*``.  ``mesh`` defaults to :func:`make_mesh` (every CUDA
    device).  ``global_strategy`` picks the body of non-local transforms:
    ``'stream'`` (default) streams the source slabs around the ring and
    sums per-slab partial samples, slab-sized memory on every device;
    ``'gather'`` gathers the source on each device and runs the planner's
    kernel on it, which materialises the full volume per device.

    ``data`` is the tuple of per-shard tensors in z order, each on its
    shard's device: the padded, prefiltered values.  An extent that does
    not divide the mesh is padded with mode-correct planes (mirror for
    'constant', zeros for 'border'), masked against the true extent and
    cropped on output."""

    def __init__(self, data, interpolation: str = "linear", mesh=None,
                 mode: str = "constant", cval: float = 0.0,
                 global_strategy: str = "stream"):
        self._configure(data.shape, interpolation, mesh, mode, cval,
                        global_strategy)
        vol = _float32(data)
        if not needs_prefilter(interpolation):
            padded = _pad_planes(vol, self._pad, mode)
            self.data = self._split(padded, copy=True)
        elif self._pad == 0 and self._local > _FIR_HALF_WIDTH:
            # shard first, prefilter shard-wise: axes 1 and 2 are local,
            # axis 0 exchanges an 18-plane halo; the full volume never
            # lies on one device
            self.data = self._sharded_prefilter(self._split(vol, copy=True))
        else:
            # slabs thinner than the filter's support (or padded): the
            # global prefilter on the TRUE extent on the first device, then
            # pad (mirror-padding the coefficients gives the coefficients
            # of the mirror extension, the prefilter's own boundary)
            coef = bspline_prefilter(vol.to(self.mesh.devices[0]))
            self.data = self._split(_pad_planes(coef, self._pad, mode),
                                    copy=True)

    def _configure(self, shape, interpolation, mesh, mode, cval,
                   global_strategy):
        if len(shape) != 3:
            raise ValueError("Expected a 3D array")
        if interpolation not in AVAILABLE_INTERPOLATIONS:
            raise ValueError(
                f"Interpolation must be one of {AVAILABLE_INTERPOLATIONS}")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if global_strategy not in ("stream", "gather"):
            raise ValueError("global_strategy must be 'stream' or 'gather', "
                             f"got {global_strategy!r}")
        self.global_strategy = global_strategy
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis_name = self.mesh.axis_names[0]
        n = self.mesh.size
        self.interpolation = interpolation
        self.mode = mode
        self.cval = float(cval)
        self.shape = tuple(int(s) for s in shape)
        d0 = self.shape[0]
        # cubic taps reach 2 planes past the edge: keep pad >= 2 (one more
        # mesh round when the remainder is 1)
        pad = (-d0) % n
        if pad and pad < 2:
            pad += n
        if pad and mode != "border" and pad > d0 - 1:
            # the mirror extension reads plane d0-2-k: only d0-1 planes
            # exist to reflect
            raise ValueError(
                f"volume depth {d0} is too small to mirror-pad to a "
                f"multiple of the {n}-device mesh (pad {pad} planes needed, "
                f"at most {d0 - 1} available); use a smaller mesh, a deeper "
                f"volume, or mode='border'")
        self._pad = pad
        self._d0p = d0 + pad
        self._local = self._d0p // n

    @classmethod
    def _from_coefficients(cls, coefficients, shape, interpolation, mesh,
                           mode, cval, global_strategy):
        """A volume holding ``coefficients`` (the true extent's, already
        prefiltered) as they are, padded for this mesh (see
        :func:`voltools_tpu_torch.convert.sharded_from_state`)."""
        sv = cls.__new__(cls)
        sv._configure(shape, interpolation, mesh, mode, cval,
                      global_strategy)
        coef = _float32(coefficients)
        sv.data = sv._split(_pad_planes(coef, sv._pad, mode), copy=True)
        return sv

    def _split(self, padded: torch.Tensor, copy: bool):
        """The shards of a padded volume, each a private contiguous tensor
        on its device."""
        local = self._local
        return tuple(
            padded[i * local:(i + 1) * local].to(dev, copy=copy)
            .contiguous() for i, dev in enumerate(self.mesh.devices))

    def _sharded_prefilter(self, raw):
        """The B-spline prefilter shard by shard (``sharded.py:310-342``):
        along axis 0 the truncated inverse filter of
        :func:`..ops.prefilter.prefilter_fir` against an 18-plane halo
        (mirror-extended at the global edges), then ``prefilter_fir`` along
        the two local axes."""
        k = _FIR_HALF_WIDTH
        taps = [float(t) for t in np.float32(
            np.sqrt(3.0) * POLE ** np.abs(np.arange(-k, k + 1,
                                                    dtype=np.float64)))]
        shards = []
        for i in range(len(raw)):
            ext = _exchange_halo(raw, i, k, edge="mirror")
            loc = raw[i].shape[0]
            out = taps[0] * ext[0:loc]
            for t in range(1, 2 * k + 1):
                out = out + taps[t] * ext[t:t + loc]
            shards.append(prefilter_fir(prefilter_fir(out, 1), 2)
                          .contiguous())
        return tuple(shards)

    # ----------------------------------------------------------- bodies

    def _local_body(self, matrix: np.ndarray, halo: int):
        """Local transform (``sharded.py:482-548``): exchange the halo,
        resample each extended slab through ``m_ext`` (one launch a
        shard), then mask z in the GLOBAL frame (the launch's own inside
        test sees the extended slab's frame)."""
        local, shape = self._local, self.shape
        edge = "zero" if self.mode == "border" else "mirror"
        outs = []
        for i in range(self.mesh.size):
            start = np.float32(i * local)
            m_glob = _shifted(matrix, start)
            m_ext = m_glob.copy()
            m_ext[0, 3] += np.float32(halo) - start
            ext = _exchange_halo(self.data, i, halo, edge)
            out = _resample(ext, m_ext, self.interpolation, self.mode,
                            self.cval, out_shape=(local,) + shape[1:])
            inside = _z_inside(m_glob, out.shape, shape[0], self.mode,
                               out.device)
            outs.append(out.masked_fill_(~inside, self.cval))
        return outs

    def _gather_body(self, matrix: np.ndarray):
        """Global transform, gathered (``sharded.py:451-481``): the volume
        gathered once per distinct device, one launch a shard through the
        slab-shifted matrix onto its output slab, re-masked along z against
        the true extent when the volume is padded."""
        local, shape = self._local, self.shape
        full = {d: _all_gather(self.data, d) for d in self.mesh.distinct}
        outs = []
        for i, dev in enumerate(self.mesh.devices):
            m_dev = _shifted(matrix, np.float32(i * local))
            out = _resample(full[dev], m_dev, self.interpolation, self.mode,
                            self.cval, out_shape=(local,) + shape[1:])
            if self._pad:
                inside = _z_inside(m_dev, out.shape, shape[0], self.mode,
                                   dev)
                out.masked_fill_(~inside, self.cval)
            outs.append(out)
        return outs

    def _stream_body(self, matrix: np.ndarray, plain: bool = False):
        """Global transform, gather-free (``sharded.py:408-450``): each
        shard adds the per-tap partial samples of the source slabs into its
        output slab as they come round the ring, the last applying the
        whole-sample mask in the global frame.  Where every slab of a
        shard's ring already lies on its device (the ring shift would hand
        back the slab itself, as on a mesh that repeats one card), the
        whole ring is one call of
        :func:`..kernels.partial_sample.partial_sample_ring` (a launch of
        the kernel D1 a shard on the card); else one step of
        :func:`..kernels.partial_sample.partial_sample` a slab (a launch a
        step).  Per shard: the output slab and the slab received; never
        the full volume.  With ``plain``, on any device, the steps are the
        plain version, each shard's coordinates and inside test formed
        once: the reference the kernel is held against."""
        n, local, shape = self.mesh.size, self._local, self.shape
        order = spline_order(self.interpolation)
        out_shape = (local,) + shape[1:]
        outs = []
        for i, dev in enumerate(self.mesh.devices):
            m_dev = _shifted(matrix, np.float32(i * local))
            ring = [(i - k) % n for k in range(n)]
            if not plain and n <= RING_CAPACITY and all(
                    self.data[j].device == dev for j in ring):
                outs.append(partial_sample_ring(
                    [self.data[j] for j in ring], [j * local for j in ring],
                    m_dev, shape, order, self.mode, out_shape, self.cval))
                continue
            acc = torch.zeros(out_shape, dtype=torch.float32, device=dev)
            frame = (sample_frame(m_dev, out_shape, shape, self.mode, dev)
                     if plain else None)
            src, src_idx = self.data[i], i
            for k in range(n):
                z0, last = src_idx * local, k == n - 1
                if frame is None:
                    partial_sample(src, m_dev, z0, shape, order, self.mode,
                                   acc, last, self.cval)
                else:
                    plain_partial_step(src, *frame, z0, shape, order,
                                       self.mode, acc, last, self.cval)
                if k < n - 1:
                    src_idx = (src_idx - 1) % n
                    src = _ring_shift(self.data[src_idx], dev)
            outs.append(acc)
        return outs

    # -------------------------------------------------------------- API

    def affine(self, transform_m: np.ndarray, output=None):
        """Apply a 4x4 pull-back matrix across the mesh
        (``sharded.py:559-580``).

        ``output=None`` returns host numpy; a numpy array of the volume's
        shape is filled (returns None); ``'device'`` returns the tuple of
        per-shard tensors in z order, each on its shard's device, cropped
        to the true extent (the counterpart of a sharded ``jax.Array``:
        nothing is gathered on one device)."""
        _check_output(output)
        if isinstance(output, np.ndarray):
            _check_shape(output.shape, self.shape)
        halo = halo_for_matrix(self.shape, transform_m, self.interpolation)
        if halo is not None and halo + 1 > self._local:
            halo = None   # the halo exceeds the slab: a global transform
        matrix = np.asarray(transform_m, np.float32)
        if halo is not None:
            outs = self._local_body(matrix, halo)
        elif self.global_strategy == "stream":
            outs = self._stream_body(matrix)
        else:
            outs = self._gather_body(matrix)
        outs = _crop(outs, self.shape[0])
        if isinstance(output, str):
            return outs
        return _finish(_host(outs), output)

    def rotate(self, rotation, rotation_units="deg", rotation_order="rzxz",
               output=None):
        return self.affine(
            rotation_matrix(rotation, rotation_units, rotation_order), output)

    def transform(self, **kwargs):
        output = kwargs.pop("output", None)
        center = kwargs.pop("center", None)
        if center is None:
            center = np.divide(np.subtract(self.shape, 1), 2,
                               dtype=np.float32)
        for k in ("scale", "shear", "rotation", "translation"):
            if k in kwargs:
                kwargs[k] = _as_triple(kwargs[k])
        m = transform_matrix(center=_as_triple(center), **kwargs)
        return self.affine(m, output)


def sharded_affine_batch(volume, matrices, interpolation: str = "linear",
                         mesh=None, mode: str = "constant", cval: float = 0.0,
                         output=None):
    """Apply N matrices to one volume, data-parallel over the mesh
    (``sharded.py:602-682``).

    The volume (prefiltered once for ``filt_bspline*``) is replicated once
    per distinct device; the batch is sharded, padded with repeats of the
    last matrix to divide the mesh, and each shard resamples its share in
    one launch of the kernel the planner routes it to.  ``output=None``
    returns the (N, *shape) stack on the host, a numpy array of that shape
    is filled (returns None), ``'device'`` returns the per-shard stacks in
    order, the padding cropped.  The JAX function's ``_plan`` and
    ``_interpret`` test hooks have no counterpart: the planner decides
    every launch."""
    mesh = mesh if mesh is not None else make_mesh()
    _check_output(output)
    n = mesh.size
    matrices = np.asarray(matrices, dtype=np.float32)
    if matrices.ndim != 3 or matrices.shape[1:] != (4, 4):
        raise ValueError("matrices must be (N, 4, 4)")
    if volume.ndim != 3:
        raise ValueError("Expected a 3D array")
    if interpolation not in AVAILABLE_INTERPOLATIONS:
        raise ValueError(
            f"Interpolation must be one of {AVAILABLE_INTERPOLATIONS}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n_true = matrices.shape[0]
    shape = tuple(int(s) for s in volume.shape)
    if isinstance(output, np.ndarray):
        _check_shape(output.shape, (n_true,) + shape)
    pad = (-n_true) % n
    if pad:   # repeats of the last matrix, cropped on return
        matrices = np.concatenate(
            [matrices, np.repeat(matrices[-1:], pad, axis=0)])
    vol = _float32(volume).to(mesh.devices[0])
    if needs_prefilter(interpolation):
        vol = bspline_prefilter(vol)
    replicas = {d: pitched(vol.to(d)) for d in mesh.distinct}
    per = matrices.shape[0] // n
    outs = [_resample(replicas[dev], matrices[i * per:(i + 1) * per],
                      interpolation, mode, float(cval))
            for i, dev in enumerate(mesh.devices)]
    outs = _crop(outs, n_true)
    if isinstance(output, str):
        return outs
    return _finish(_host(outs), output)
