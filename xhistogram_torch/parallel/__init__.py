"""Histograms of data sharded over a ``torch.distributed`` ``DeviceMesh``
(``histogram_sharded``): the counterpart of ``xhistogram_tpu.parallel``.
Importing it registers the kernel ops' DTensor sharding rules
(``ops.partitioning``)."""

from ..ops import partitioning as _partitioning
from .sharded import histogram_sharded, reduce_spec  # noqa: F401

_partitioning.rules()
