"""Multi-rank histograms: per-rank kernel partials joined by an all-reduce.

Counterpart of ``xhistogram_tpu.parallel.sharded``, where each TPU device
histograms its shard inside ``shard_map`` and one ``psum`` over the mesh
axes that shard reduced data axes completes the histogram (the reference's
dask tree-sum, reference core.py:403-439). Here the mesh is a
``torch.distributed`` ``DeviceMesh``:

  1. every rank histograms its own block with the one-card pipeline
     (``core._histogram_impl``), so ``plan()`` routes the block to the same
     CUDA kernel a one-card call of that shape runs (its plain version on
     CPU tensors);
  2. each mesh dim that shards a reduced data axis adds the ranks' slot
     sums with one ``torch.distributed.all_reduce`` (NCCL between cards,
     gloo between CPU processes), outside the kernels; sums stay in their
     accumulator (int64 counts, float64 float sums, int32 or int64 integer
     sums) until after it, so a float32 sum is rounded once, as on one card;
  3. kept data axes stay sharded: the result is a ``DTensor`` that is
     ``Shard`` on the mesh dims of its kept axes and ``Replicate`` on the
     rest, and density is taken after the all-reduce, from global per-row
     totals.

torch.distributed runs one program per rank, so **every rank of the mesh
makes the same call**, with inputs that are ``DTensor``s on the mesh or
full tensors (or numpy arrays) that every rank holds alike; each rank takes
its own block of a full input, and nothing is scattered from one rank.
Every choice a rank makes from its own data is first agreed over the mesh
(the bin range of ``bins=int``, a NaN that makes it fail, the passes of
``precision='f64'``), so the ranks run the same collectives and raise the
same errors.

Removed with the TPU's lack of 64-bit integers: the uint32-pair "wide"
partials psummed as 16-bit halves, the per-digit ``digN`` passes with
their ``_INTW_CHUNK`` guard (int64 holds every count and limb sum a mesh
can produce), and shard_map's ``check_vma``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from .. import bins as _bins
from ..core import (
    _coerce_host, _coerce_weights, _finish_histogram, _histogram_impl,
    _resolve_device,
)
from ..utils.axes import normalize_axis
from ..utils.profiling import scope

__all__ = ["histogram_sharded", "reduce_spec", "ALL_REDUCES"]

#: all-reduces of partial slot sums in this process: one per mesh dim that
#: shards a reduced axis, per counting pass (one pass, but for
#: precision='f64'). The agreements on bin ranges and on the f64 passes
#: are small collectives of their own, not counted here
ALL_REDUCES = 0

# `range` is a histogram keyword (reference API name)
_builtin_range = range

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def reduce_spec(spec, axis, ndim):
    """Split an input spec into (the kept axes' out spec, the mesh dims to
    all-reduce), as ``xhistogram_tpu.parallel.reduce_spec`` splits a
    ``PartitionSpec``: mesh dims on reduced data axes are all-reduced, those
    on kept axes stay on the output (bin axes are never sharded)."""
    axis = normalize_axis(axis, ndim)
    entries = list(spec) + [None] * (ndim - len(spec))
    reduced, out = [], []
    for i, entry in enumerate(entries):
        if axis is None or i in axis:
            if entry is not None:
                reduced.extend(entry if isinstance(entry, tuple) else (entry,))
        else:
            out.append(entry)
    return tuple(out), tuple(reduced)


class _Mesh:
    """One call's mesh: where each data axis is sharded, this rank's block,
    and the collectives ``core._histogram_impl`` calls (``sum``, ``agree``,
    ``n_cols``)."""

    def __init__(self, mesh, in_spec, shape, axis_t):
        self.mesh = mesh
        names = mesh.mesh_dim_names or ()
        if len(in_spec) > len(shape):
            raise ValueError(
                f"in_spec {in_spec} has {len(in_spec)} entries for data of "
                f"rank {len(shape)}"
            )
        self.dims = []  # per data axis: the mesh dims sharding it, major first
        used = []
        for entry in list(in_spec) + [None] * (len(shape) - len(in_spec)):
            entry = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
            dims = []
            for name in entry:
                if isinstance(name, int) and 0 <= name < mesh.ndim:
                    dims.append(name)
                elif name in names:
                    dims.append(names.index(name))
                else:
                    raise ValueError(
                        f"in_spec names mesh dim {name!r}, which the mesh "
                        f"{names or tuple(_builtin_range(mesh.ndim))} does not have"
                    )
            used += dims
            self.dims.append(tuple(dims))
        if len(set(used)) != len(used):
            raise ValueError(f"in_spec {in_spec} names a mesh dim twice")
        for size, dims in zip(shape, self.dims):
            parts = math.prod(mesh.size(d) for d in dims)
            if size % parts:
                raise ValueError(
                    f"a data axis of size {size} does not divide evenly over "
                    f"the {parts} ranks of mesh dims {dims} that shard it"
                )
        self.shape = shape
        self.kept = [i for i in _builtin_range(len(shape))
                     if axis_t is not None and i not in axis_t]
        for i in self.kept:
            if list(self.dims[i]) != sorted(self.dims[i]):
                raise NotImplementedError(
                    f"kept data axis {i} is sharded over mesh dims {self.dims[i]} "
                    "out of the mesh's order, which a DTensor cannot lay out; "
                    "name them in mesh order"
                )
        reduced = [i for i in _builtin_range(len(shape)) if i not in self.kept]
        self.reduce_dims = tuple(d for i in reduced for d in self.dims[i])
        self.n_cols = math.prod(shape[i] for i in reduced)
        self.device = _resolve_device(torch.device(mesh.device_type))

    def placements(self, ndim, sizes=None):
        """DTensor placements of an operand of rank ``ndim`` (its own shape
        ``sizes``, right-aligned to the data's; a length-1 axis is a
        broadcast and is not sharded), or of the output (``sizes=None``:
        the kept axes, then the bin axes)."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * self.mesh.ndim
        if sizes is None:
            axes = [(j, i) for j, i in enumerate(self.kept)]
        else:
            offset = len(self.shape) - ndim
            axes = [(j, j + offset) for j in _builtin_range(ndim)
                    if sizes[j] == self.shape[j + offset] != 1]
        for j, i in axes:
            if list(self.dims[i]) != sorted(self.dims[i]):
                return None  # not in mesh order: no DTensor layout
            for d in self.dims[i]:
                out[d] = Shard(j)
        return out

    def block(self, x):
        """This rank's block of a full operand (a view where ``x`` is a
        tensor): the slice of each sharded axis it holds, broadcast axes
        whole."""
        offset = len(self.shape) - x.ndim
        index = []
        for j, n in enumerate(x.shape):
            dims = self.dims[j + offset]
            if n == 1 or not dims:
                index.append(slice(None))
                continue
            k = 0
            for d in dims:
                k = k * self.mesh.size(d) + self.mesh.get_local_rank(d)
            chunk = n // math.prod(self.mesh.size(d) for d in dims)
            index.append(slice(k * chunk, (k + 1) * chunk))
        return x[tuple(index)]

    def local(self, x, dtensor):
        """This rank's block of operand ``x``, a tensor on the mesh's
        device. A DTensor laid out as ``in_spec`` gives its local tensor,
        another is redistributed (gathered where no DTensor layout is
        ``in_spec``'s); a full tensor that requires grad goes through a
        replicated DTensor, so the gradient of every element reaches every
        rank, as DTensor's own ops give it."""
        want = self.placements(x.ndim, tuple(x.shape))
        if isinstance(x, dtensor):
            if x.device_mesh != self.mesh:
                raise ValueError("a DTensor input lies on another mesh than mesh=")
            if want is not None:
                return x.redistribute(self.mesh, want).to_local()
            return self.block(x.full_tensor())
        if isinstance(x, torch.Tensor) and x.requires_grad and want is not None:
            from torch.distributed.tensor import DTensor, Replicate

            x = x.to(self.device)
            full = DTensor.from_local(x, self.mesh, [Replicate()] * self.mesh.ndim,
                                      run_check=False)
            return full.redistribute(self.mesh, want).to_local()
        x = self.block(x if isinstance(x, torch.Tensor) else torch.from_numpy(x))
        return x.to(self.device)

    def _all_reduce(self, t, op, dims):
        for d in dims:
            dist.all_reduce(t, op=_OPS[op], group=self.mesh.get_group(d))
        return t

    def sum(self, t):
        """The slot sums ``t`` (this rank's, in place) added over the ranks
        of the mesh dims that shard reduced axes."""
        global ALL_REDUCES
        ALL_REDUCES += len(self.reduce_dims)
        with scope("all_reduce"):
            return self._all_reduce(t.contiguous(), "sum", self.reduce_dims)

    def agree(self, t, op):
        """``t`` reduced by ``op`` ("min", "max", "sum") over every rank of
        the mesh, so every rank takes the same decision from it."""
        return self._all_reduce(t.clone(), op, _builtin_range(self.mesh.ndim))

    def output(self, h, nbins):
        """The local result as a DTensor of the global kept shape and bins."""
        from torch.distributed.tensor import DTensor

        shape = tuple(self.shape[i] for i in self.kept) + nbins
        stride = [math.prod(shape[k + 1:]) for k in _builtin_range(len(shape))]
        return DTensor.from_local(h, self.mesh, self.placements(len(shape)),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=tuple(stride))


def _host_dtype(x):
    """The numpy dtype ``np.histogram_bin_edges`` sees for input ``x``
    (``bins._host_data``: narrow integers and bool as int32, bfloat16 as
    float32)."""
    if isinstance(x, np.ndarray):
        dtype = x.dtype
    elif x.dtype == torch.bfloat16:
        dtype = np.dtype(np.float32)
    else:
        dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
    if dtype.kind in "iub" and dtype.itemsize < 4:
        return np.dtype(np.int32)
    return dtype


def _data_range(block, dtype, mesh):
    """``np.histogram_bin_edges``' view of the global data of one input
    from this rank's ``block``: a two-element array (its minimum and
    maximum, NaN where any value is NaN) of the input's host dtype, agreed
    over the mesh, so every rank resolves the same edges, or raises numpy's
    error for NaN, bit for bit as on the gathered data."""
    if dtype.kind == "f":
        x = block.to(torch.float64)
        nan = torch.isnan(x).any()
        x = x[~torch.isnan(x)]
        lo = x.amin() if x.numel() else x.new_tensor(math.inf)
        hi = x.amax() if x.numel() else x.new_tensor(-math.inf)
        neg_lo, hi, nan = mesh.agree(torch.stack([-lo, hi, nan.to(torch.float64)]),
                                     "max").tolist()
        if nan:
            return np.array([math.nan, math.nan], dtype)
        return np.array([-neg_lo, hi], dtype)
    x = block.view(torch.int64) ^ -(1 << 63) if block.dtype == torch.uint64 else block
    x = x.to(torch.int64)  # torch has no min or max of uint32
    lo = mesh.agree(x.amin().reshape(1), "min")
    hi = mesh.agree(x.amax().reshape(1), "max")
    out = np.array([int(lo), int(hi)], np.int64)
    if block.dtype == torch.uint64:  # the flip back
        out = out.view(np.uint64) ^ np.uint64(1 << 63)
    return out.astype(dtype)


def _resolve_edges(args, blocks, weights, bins, range_, mesh, dtensor):
    """The bin edges of a sharded call, the same on every rank: explicit
    edges as given; ``bins=int`` from the global minimum and maximum
    (``_data_range``); a ``str`` spec from the data gathered on every rank
    (``full_tensor()``), since numpy's estimators read all of it."""
    specs = _bins.normalize_bins(bins, len(args))
    if any(isinstance(b, str) for b in specs):
        def full(x):
            return x.full_tensor() if isinstance(x, dtensor) else x
        return _bins.resolve_bin_edges([full(a) for a in args], bins, range_,
                                       None if weights is None else full(weights))
    ranges = _bins.normalize_range(range_, len(args))
    edges = []
    for a, block, b, r in zip(args, blocks, specs, ranges):
        if isinstance(b, np.ndarray):
            edges.append(_bins.validate_edges(b))
            continue
        dtype = _host_dtype(a)
        sample = np.zeros(0, dtype)
        if r is None and math.prod(a.shape):
            sample = _data_range(block, dtype, mesh)
        edges.append(np.histogram_bin_edges(sample, bins=b, range=r))
    return edges


def histogram_sharded(
    *args,
    mesh,
    in_spec,
    bins=None,
    range=None,
    axis=None,
    weights=None,
    density=False,
    block_size="auto",
    method="auto",
    precision=None,
):
    """Histogram of data sharded over a ``DeviceMesh``; every rank of the
    mesh makes the same call.

    Parameters
    ----------
    args : DTensors on ``mesh``, or tensors or numpy arrays that every rank
        holds alike. They broadcast against each other and ``weights``, and
        ``in_spec`` lays out the broadcast shape; each rank takes its own
        block (a DTensor laid out otherwise is redistributed).
    mesh : torch.distributed.device_mesh.DeviceMesh, with named dims (an
        unnamed mesh's dims are named by their index).
    in_spec : tuple, one entry per data axis (missing trailing entries are
        None), in the form of a JAX ``PartitionSpec``: None, a mesh dim
        name, or a tuple of names (the first major), e.g. ``("x", "y")``,
        ``(None, "y")``, ``(("x", "y"), None)``. Data axis ``i`` is
        ``Shard(i)`` on each named dim and replicated over the others; each
        sharded axis divides evenly over its dims, else ``ValueError``.
    bins, range, axis, weights, density, block_size, method, precision
        As for ``core.histogram``. ``bins=int`` without ``range`` reads the
        global minimum and maximum (small all-reduces), so NaN data
        raise numpy's ``ValueError`` on every rank; a ``str`` spec gathers
        all the data on every rank (``full_tensor()``). ``precision='f64'``
        all-reduces each int64 limb pass before the double-double combine
        and agrees every choice of passes over the mesh, so its sums are
        bit-equal to a one-card call's.

    Returns
    -------
    hist : DTensor on ``mesh`` with the kept axes' shape then the bins:
        ``Shard`` on the mesh dims of kept axes, ``Replicate`` on those
        that sharded reduced axes (all-reduced, one all-reduce per such
        dim: ``ALL_REDUCES``) and on unused ones. Its dtype is the
        one-card call's; float weights that require grad get the one-card
        call's gradient.
    bin_edges : list of np.ndarray, the same on every rank.
    """
    with scope("call", call=True):
        if not args:
            raise ValueError("histogram_sharded() requires at least one input array")
        from torch.distributed.tensor import DTensor

        def coerce(x, weights=False):
            if isinstance(x, DTensor):
                return x
            return (_coerce_weights if weights else _coerce_host)(x)

        args = [coerce(a) for a in args]
        if weights is not None:
            weights = coerce(weights, weights=True)
        operands = args if weights is None else [*args, weights]
        try:
            shape = tuple(np.broadcast_shapes(*(tuple(a.shape) for a in operands)))
        except ValueError:
            raise ValueError(
                "Incompatible shapes for broadcasting: shapes="
                f"{[tuple(a.shape) for a in operands]}"
            ) from None
        axis_t = normalize_axis(axis, len(shape))
        layout = _Mesh(mesh, tuple(in_spec), shape, axis_t)
        blocks = [layout.local(a, DTensor) for a in args]
        w_block = None if weights is None else layout.local(weights, DTensor)

        with scope("edges"):
            edges_np = _resolve_edges(args, blocks, weights, bins, range, layout, DTensor)
        sums, kshape, w_dtype = _histogram_impl(
            blocks, w_block, edges_np, bins, axis_t, method=method,
            block_size=block_size, precision=precision, mesh=layout,
        )
        h = _finish_histogram(sums, w_dtype, kshape, edges_np, density)
        nbins = tuple(int(e.shape[0]) - 1 for e in edges_np)
        return layout.output(h, nbins), edges_np
