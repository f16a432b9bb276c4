"""Faults planted under the timed path: ``harness.run_cell(hook=...)``
calls one with the cell before the run, and the function it returns after
it. Each fault must make ``correct`` false."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from xhistogram_torch.parallel import sharded

from portbench.control import replace_impl as _patch_impl


def altered_answer(cell):
    """One bin's sum doubled where the sums are produced."""

    def wrap(impl):
        def altered(*args, **kwargs):
            sums, kshape, w_dtype = impl(*args, **kwargs)
            flat = sums.reshape(-1)
            j = int(torch.nonzero(flat)[0])
            flat[j] = flat[j] * 2
            return sums, kshape, w_dtype
        return altered

    return _patch_impl(wrap)


def half_the_data(cell):
    """The second half of the leading axis left out of every call."""

    def wrap(impl):
        def halved(args, weights, *rest, **kwargs):
            n = args[0].shape[0]
            args = [a[: n // 2] for a in args]
            if weights is not None and weights.ndim == args[0].ndim and weights.shape[0] == n:
                weights = weights[: n // 2]
            return impl(args, weights, *rest, **kwargs)
        return halved

    return _patch_impl(wrap)


def dropped_part(cell):
    """The last rank's part left out of the program's all-reduce
    (``parallel.sharded._Mesh.sum``): it adds zeros in its place."""
    add = sharded._Mesh.sum

    def dropped(self, t):
        if _last_rank():
            t = torch.zeros_like(t)
        return add(self, t)

    sharded._Mesh.sum = dropped

    def undo():
        sharded._Mesh.sum = add

    return undo


def _last_rank():
    return dist.get_rank() == dist.get_world_size() - 1


def a_rank_fails(cell):
    """The last rank raises before its first seed."""
    if _last_rank():
        raise RuntimeError("a failure planted on the last rank")
    return lambda: None


def a_rank_hangs(cell):
    """The last rank never reaches its first seed."""
    if _last_rank():
        time.sleep(3600)
    return lambda: None
