"""Out-of-core histograms: stream chunks through the card.

Counterpart of ``xhistogram_tpu.streaming``. The reference scales beyond
memory with dask: ``blockwise`` maps the kernel over chunks and the
scheduler tree-sums the partial histograms (reference core.py:403-439). On
one card the same decomposition is a loop — histograms commute with
concatenation along *reduced* axes — so ``StreamingHistogram`` computes
each chunk's partial with ``core.histogram`` on the card and adds it into
accumulators that stay there: int64 counts, float64 sums, uint64 sums added
as their int64 bits (equal mod 2**64) and, for ``precision='f64'``, a
double-double ``lo`` term per block. Density waits for ``result()``, where
the reference normalizes too (after the tree-sum, core.py:439-462).

    acc = StreamingHistogram(bins=[t_edges, s_edges], axis=1)
    for T_chunk, S_chunk, w_chunk in loader:          # e.g. zarr/netCDF reads
        acc.update(T_chunk, S_chunk, weights=w_chunk)
    h, edges = acc.result(density=True)

Host chunks (numpy arrays, Python sequences and CPU tensors) are copied
into pinned staging buffers and sent with ``non_blocking`` copies on a side
stream; the compute stream waits on each copy's event, so chunk k+1's copy
overlaps chunk k's kernels, and each staging buffer is kept until the
kernels that read its chunk are done. ``update()`` does not synchronise
with the host (the thresholds of the edges are cached on the card after the
first chunk), except under ``precision='f64'`` with float weights, whose
exponent groups are read on the host to choose each chunk's passes.

Chunks may tile the *kept* (bystander) axes too — the reference's blockwise
path handles chunked kept dims natively (reference core.py:418,429-437).
Pass ``kept_offset`` to ``update()`` with the chunk's starting index along
each kept axis of the output; chunks sharing an offset accumulate, and
``result()`` stitches the kept-axis blocks back together, validating that
they tile the output exactly (no gaps, no overlaps-by-misalignment).

Like the reference's dask bins guard (reference core.py:377-381), int/str
bin specs are rejected: resolving them needs global data the stream cannot
see.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bins as _bins_mod
from .core import _coerce_host, _coerce_weights, _dd_add, _resolve_device, histogram
from .ops.cuda_hist import validate_public_precision

__all__ = ["StreamingHistogram"]

_NO_CARD_MSG = (
    "no CUDA card is available: StreamingHistogram accumulates on the card "
    "unless asked otherwise; pass device=\"cpu\" to run on the CPU"
)


class StreamingHistogram:
    """Accumulate an axis-selective joint histogram over data chunks.

    Parameters mirror ``core.histogram`` (reference core.py:250-258) except
    ``bins`` must be explicit edge arrays (one per input) and ``density``
    moves to ``result()``. ``device`` is where the chunks are histogrammed
    and the accumulators live: by default the CUDA card (``RuntimeError``
    without one; pass ``device="cpu"``). Chunks that are tensors on another
    card raise, as in ``core.histogram``.
    """

    def __init__(self, bins, *, range=None, axis=None, method="auto",
                 block_size="auto", precision=None, device=None):
        bins_list = bins if isinstance(bins, (list, tuple)) else [bins]
        # Accept anything that IS a 1-D sequence of edges (ndarray, or a
        # flat list of floats); reject int/str specs, which need global
        # data the stream cannot see (the streaming analog of the
        # reference's dask guard, reference core.py:377-381). A flat list
        # of INTS is ambiguous (per-input int bin-count specs vs one
        # input's integer edges) — refuse with guidance rather than guess.
        if isinstance(bins, (list, tuple)) and bins and np.isscalar(bins[0]):
            if all(isinstance(b, (int, np.integer)) for b in bins):
                raise TypeError(
                    "ambiguous flat list of ints for bins: int bin-COUNT "
                    "specs need global data the stream cannot see "
                    "(reference core.py:377-381); for integer bin EDGES "
                    "of a single input pass np.asarray(edges) or "
                    "[edges_list]"
                )
            bins_list = [bins]  # a single flat list of (float) edge values
        bins_list = [_bins_mod.concrete_edges(b) for b in bins_list]
        for b in bins_list:
            if isinstance(b, (int, str)) or np.ndim(b) != 1:
                raise TypeError(
                    "StreamingHistogram requires explicit 1-D bin-edge "
                    "arrays (int/str specs need global data the stream "
                    "cannot see — same contract as the reference's dask "
                    "guard, reference core.py:377-381)"
                )
            _bins_mod.validate_edges(b)  # fail at construction, not at
            # the first update
        self._bins = [np.asarray(b) for b in bins_list]
        self._n_inputs = len(self._bins)
        if range is not None:
            raise TypeError(
                "range= is meaningless with explicit edge arrays; bake the "
                "range into the edges"
            )
        self._axis = axis
        self._method = method
        self._block_size = block_size
        if precision is not None and precision != "f64":
            validate_public_precision(precision)  # at init, not 1st update
        self._precision = precision
        self._device = _resolve_device(device, no_card_msg=_NO_CARD_MSG)
        self._blocks = None  # {kept_offset tuple: accumulator on the device}
        # precision='f64' cross-chunk contract: each chunk's partial is
        # correctly rounded float64, and a double-double compensation term
        # per block (``_blocks_lo``) adds the partials EXACTLY across the
        # whole stream, so cross-chunk cancellation is preserved (1e16 in
        # one chunk, -1e16 in another, 1.0 in a third gives exactly 1.0).
        # What remains is each chunk's own final rounding.
        self._blocks_lo = None
        self._edges = None
        self._weighted = None  # pinned by the first accepted update()
        self._unsigned = False  # uint64 sums, kept as their int64 bits
        self._copy_stream = None
        self._staged = []  # (event after the kernels, pinned buffers)
        self._pending = []  # this chunk's pinned buffers

    # -- host chunks to the card ------------------------------------------------
    def _place(self, x, is_weights):
        """``x`` as a tensor on the accumulator's device, staged through
        pinned memory when it lies on the host (on the CPU, as
        ``core.histogram`` takes it)."""
        dev = self._device
        x = _coerce_weights(x) if is_weights else _coerce_host(x)
        if dev.type == "cpu" or (isinstance(x, torch.Tensor) and x.device.type != "cpu"):
            return x  # core places it (a tensor on another card raises there)
        if isinstance(x, np.ndarray):
            dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
            pinned = torch.empty(x.shape, dtype=dtype, pin_memory=True)
            if x.flags.writeable:  # torch's copy runs on several threads
                pinned.copy_(torch.from_numpy(x))
            else:  # a broadcast view, which torch does not wrap
                pinned.numpy()[...] = x
        else:
            pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            pinned.copy_(x)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._copy_stream):
            out = pinned.to(dev, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        compute = torch.cuda.current_stream(dev)
        compute.wait_event(copied)
        out.record_stream(compute)  # allocated on the copy stream, read here
        self._pending.append(pinned)
        return out

    def _stage(self, args, weights):
        """The chunk's operands on the accumulator's device; the pinned
        buffers of earlier chunks whose kernels are done are released."""
        self._staged = [(ev, bufs) for ev, bufs in self._staged if not ev.query()]
        self._pending = []
        placed = [self._place(a, False) for a in args]
        w = None if weights is None else self._place(weights, True)
        return placed, w

    def _release_after_kernels(self):
        if self._pending:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self._device))
            self._staged.append((done, self._pending))
        self._pending = []

    # -- accumulation -------------------------------------------------------------
    def update(self, *args, weights=None, kept_offset=None):
        """Add one chunk (N input arrays [+ weights]).

        ``kept_offset`` — starting index of this chunk along each *kept*
        axis of the output (one int per kept axis, in kept-axes order);
        omit it (or pass zeros) when chunks tile only the reduced axes.
        Chunks with the same offset accumulate; ``result()`` stitches the
        distinct kept-axis blocks (the reference's chunked-bystander-dim
        blockwise semantics, reference core.py:418,429-437)."""
        if len(args) != self._n_inputs:
            raise ValueError(
                f"expected {self._n_inputs} input arrays (one per bins "
                f"entry), got {len(args)}"
            )
        weighted = weights is not None
        if self._weighted is not None and self._weighted != weighted:
            raise ValueError(
                "cannot mix weighted and unweighted chunks in one "
                "accumulator (counts and weighted sums are different "
                "quantities); pass weights of ones if that mix is intended"
            )
        args, weights = self._stage(args, weights)
        try:
            h, edges = histogram(
                *args,
                bins=self._bins,
                axis=self._axis,
                weights=weights,
                density=False,
                method=self._method,
                block_size=self._block_size,
                precision=self._precision,
                device=self._device,
            )
        finally:
            self._release_after_kernels()
        h = h.detach()
        n_kept = h.ndim - self._n_inputs
        if kept_offset is None:
            kept_offset = (0,) * n_kept
        else:
            kept_offset = tuple(int(o) for o in kept_offset)
            if len(kept_offset) != n_kept:
                raise ValueError(
                    f"kept_offset has {len(kept_offset)} entries but this "
                    f"chunk keeps {n_kept} axes (one offset per kept axis, "
                    "in kept-axes order)"
                )
        if self._blocks is not None:
            n_kept_acc = len(next(iter(self._blocks)))
            if n_kept != n_kept_acc:
                raise ValueError(
                    f"chunk keeps {n_kept} axes but the accumulator was "
                    f"started with {n_kept_acc} kept axes: chunks may only "
                    "vary along reduced (and offset kept) axes"
                )
            prev = self._blocks.get(kept_offset)
            if prev is not None and h.shape != prev.shape:
                raise ValueError(
                    f"chunk produced kept-axes/bin shape {tuple(h.shape)}, "
                    f"accumulator at kept_offset {kept_offset} holds "
                    f"{tuple(prev.shape)}: chunks at one offset may only vary "
                    "along reduced axes"
                )
        # pin weighted-ness only once the chunk was actually accepted (a
        # failed first update must not poison the accumulator's mode)
        self._weighted = weighted
        # wide accumulators: int64 counts (no overflow however many chunks
        # stream through — the reference's int64 contract), uint64 sums as
        # their int64 bits, float64 sums
        if h.dtype == torch.uint64:
            h = h.view(torch.int64)
            unsigned = True
        else:
            unsigned = False
            h = h.to(torch.float64 if h.is_floating_point() else torch.int64)
        dd = self._precision == "f64" and weighted and h.is_floating_point()
        if self._blocks is None:
            self._blocks = {kept_offset: h.clone()}
            if dd:
                self._blocks_lo = {kept_offset: torch.zeros_like(h)}
            self._edges = edges
            self._unsigned = unsigned
            return self
        prev = self._blocks.get(kept_offset)
        if prev is None:
            dtype = next(iter(self._blocks.values())).dtype  # the first chunk's
            self._blocks[kept_offset] = h.to(dtype).clone()
            if self._blocks_lo is not None:
                self._blocks_lo[kept_offset] = torch.zeros_like(h)
        elif self._blocks_lo is not None:
            # double-double accumulation: the correctly rounded chunk
            # partials add EXACTLY across chunks; overflowing slots give
            # ±inf in hi and NaN in lo, masked when the blocks are read
            hi, lo = _dd_add(prev, self._blocks_lo[kept_offset], h.to(prev.dtype))
            self._blocks[kept_offset] = hi
            self._blocks_lo[kept_offset] = lo
        else:
            # the accumulator's dtype is the first chunk's
            prev += h.to(prev.dtype)
        return self

    def _output(self, t):
        return t.view(torch.uint64) if self._unsigned else t

    def _combined_blocks(self):
        """The per-offset block values: the accumulators, or — under the
        precision='f64' double-double accumulation — hi + lo, with ±inf
        where the exact sum overflowed (hi is ±inf there, lo NaN)."""
        if self._blocks_lo is None:
            return self._blocks
        return {
            off: torch.where(torch.isinf(hi), hi, hi + self._blocks_lo[off])
            for off, hi in self._blocks.items()
        }

    def _stitched(self):
        """Concatenate the kept-offset blocks into the full output (a new
        tensor), validating that the offsets+shapes tile the kept space
        exactly."""
        blocks = self._combined_blocks()
        n_kept = len(next(iter(blocks)))
        # the single-block shortcut applies only to the zero offset: one
        # block at a nonzero kept_offset does NOT tile the output (rec()
        # below raises the gap error for it)
        if n_kept == 0 or set(blocks) == {(0,) * n_kept}:
            (only,) = blocks.values()
            return only.clone()

        def rec(sub, axis):
            if axis == n_kept:
                (only,) = sub.values()
                return only
            groups = {}
            for off, arr in sub.items():
                groups.setdefault(off[axis], {})[off] = arr
            parts, expect = [], 0
            for o in sorted(groups):
                if o != expect:
                    raise ValueError(
                        f"kept-axis {axis} blocks do not tile the output: "
                        f"expected a block starting at {expect}, found "
                        f"offset {o} (gap or overlap)"
                    )
                part = rec(groups[o], axis + 1)
                parts.append(part)
                expect = o + part.shape[axis]
            return torch.cat(parts, dim=axis)

        return rec(blocks, 0)

    @property
    def blocks(self):
        """Per-kept-offset accumulated blocks (dict: offset tuple → a copy on
        the accumulator's device: int64 counts, float64 or integer sums), or
        None before any update. Always available mid-stream — use this for
        progress monitoring or checkpointing while the streamed kept-axis
        blocks do not yet tile the output (``counts`` raises in that
        state). They are copies, so editing one leaves the accumulator as
        it was."""
        if self._blocks is None:
            return None
        return {off: self._output(t.clone())
                for off, t in self._combined_blocks().items()}

    @property
    def counts(self):
        """Accumulated counts so far (a tensor on the accumulator's device:
        int64 counts, float64 or integer sums), stitched over any kept-axis
        blocks; None before any update. Raises ValueError while kept-offset
        blocks streamed so far leave gaps (they cannot be stitched into one
        array yet) — poll ``blocks`` for mid-stream state instead."""
        if self._blocks is None:
            return None
        return self._output(self._stitched())

    def result(self, density=False):
        """(hist, bin_edges) over everything seen so far; ``hist`` lies on
        the accumulator's device.

        ``density=True`` normalizes per bystander row over the *global*
        counts (reference core.py:444-462 semantics — NaN rows normalize
        independently) in float64, which is why density cannot be computed
        per chunk.
        """
        if self._blocks is None:
            raise ValueError("result() before any update()")
        h = self._stitched()
        if not density:
            return self._output(h), self._edges
        h = h.to(torch.float64)
        if self._unsigned:  # the int64 bits of uint64 sums
            h = torch.where(h < 0, h + 2.0**64, h)
        bin_axes = tuple(range(-self._n_inputs, 0))
        area = torch.as_tensor(_bins_mod.bin_areas(self._edges),
                               dtype=torch.float64, device=h.device)
        totals = h.sum(dim=bin_axes, keepdim=True)
        return h / area / totals, self._edges
