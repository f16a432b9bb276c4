"""Faults planted under the timed path: ``harness.run_cell(hook=...)``
calls one with the cell before the run, and the function it returns after
it. Each fault must make ``correct`` false."""

from __future__ import annotations

import torch

import xhistogram_torch.core as core


def _patch_impl(fn):
    impl = core._histogram_impl
    core._histogram_impl = fn(impl)

    def undo():
        core._histogram_impl = impl

    return undo


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
