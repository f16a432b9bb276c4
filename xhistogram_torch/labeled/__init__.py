"""Labeled histograms: named dims and coordinates over torch tensors
(counterpart of ``xhistogram_tpu.labeled``)."""

from .array import NamedArray, full_like  # noqa: F401
from .api import histogram  # noqa: F401
