"""DTensor sharding rules for the kernel ops.

Counterpart of ``xhistogram_tpu.ops.partitioning``, which wraps the Pallas
dispatch in a ``custom_partitioning`` node so that a caller's ``jit`` over
sharded inputs runs the kernel per shard with one ``psum`` instead of
gathering the operands. Here each registered op of ``ops.cuda_hist``
(``xhistogram::one_input``, ``::joint2``, ``::factored``, ``::direct``)
gets a ``register_sharding`` rule, so a ``DTensor`` that reaches an op runs
the op on each rank's local block and DTensor adds the partials where it
needs them; no operand is gathered. Per mesh dim, the rules allow:

  - data and weights sharded on the reduced (column) dim: each rank's slot
    sums are a ``Partial()`` (sum) of the result;
  - data and weights sharded on a kept-row dim (the first of an ``(m, c)``
    layout, either of the first two of an ``(m1, m0, c1, c0)`` view): the
    result is ``Shard`` on that dim of its kept rows, or ``Partial()``
    where the op reduces all rows (joint2; one_input and factored with
    ``reduce_all``), which reduces every dim;
  - everything replicated.

Thresholds are always ``Replicate()``. The outputs are the ops' accumulator
sums (int64 counts; float64, int32 or int64 sums), which add exactly, or
wrap as their dtype does, in any order of ranks. The direct op's float32
rows (``finish=True`` with float weights narrower than float64) are
rounded already, so they are never a ``Partial()``: columns sharded there
are gathered first.

The JAX node's bypasses have no counterpart: ``XHIST_CUSTOM_PARTITION``,
the ``custom_vmap`` rule (vmap becomes a batch axis, ``axis=``), and the
gates for shard_map's manual axes and the TPU interpreter's effects.
"""

from __future__ import annotations

import torch

__all__ = ["rules"]


def _rules(n_data, weighted, reduce_all, ndim=2, partial=True, kept_dims=1):
    """Acceptable (output, inputs) placements for one mesh dim: the inputs
    are the op's tensors in order, ``n_data`` data tensors, as many
    thresholds, then the weights. The first ``kept_dims`` dims of the data
    are kept rows, each the same dim of the output (an ``(m, c)`` layout
    keeps one, an ``(m1, m0, c1, c0)`` view two), and the rest reduced
    columns. ``partial=False`` leaves out the placements whose output is a
    ``Partial()``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def inputs(p):
        return [p] * n_data + [Replicate()] * n_data + ([p] if weighted else [])

    rules = [([Replicate()], inputs(Replicate()))]
    for dim in range(ndim):
        kept = dim < kept_dims and not reduce_all
        if kept or partial:
            rules.append(([Shard(dim) if kept else Partial()], inputs(Shard(dim))))
    return rules


def _kept_dims(x):
    """The kept-row dims of a kernel operand: two of a 4-D view, one of a
    layout."""
    return 2 if x.ndim == 4 else 1


def rules():
    """Register the rule of each kernel op with DTensor (once per process;
    ``xhistogram_torch.parallel`` calls it on import)."""
    from torch.distributed.tensor.experimental import register_sharding

    ops = torch.ops.xhistogram

    @register_sharding(ops.one_input.default)
    def one_input(a2d, thr, weights, nb, reduce_all):
        return _rules(1, weights is not None, reduce_all, a2d.ndim,
                      kept_dims=_kept_dims(a2d))

    @register_sharding(ops.joint2.default)
    def joint2(a, b, thr_a, thr_b, weights, nba, nbb):
        return _rules(2, weights is not None, True, ndim=a.ndim)

    @register_sharding(ops.factored.default)
    def factored(arrays, thresholds, weights, nbins, reduce_all):
        return _rules(len(arrays), weights is not None, reduce_all,
                      arrays[0].ndim, kept_dims=_kept_dims(arrays[0]))

    # DTensor caches a rule's choice by the arguments from the op's first
    # int on (register_sharding's RuntimeSchemaInfo), and factored has no
    # int: an int[] and a bool do not count, so without this a full
    # reduction and kept rows would share one choice
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo

    DTensor._op_dispatcher.sharding_propagator.op_to_schema_info[
        ops.factored.default] = RuntimeSchemaInfo(static_argnum=3, needs_pytree=True)

    from .cuda_hist import _ROUNDED

    @register_sharding(ops.direct.default)
    def direct(arrays, thresholds, weights, nbins, finish=False):
        rounded = (finish and weights is not None
                   and weights.tensor_meta.dtype in _ROUNDED)
        return _rules(len(arrays), weights is not None, False, arrays[0].ndim,
                      partial=not rounded, kept_dims=_kept_dims(arrays[0]))
