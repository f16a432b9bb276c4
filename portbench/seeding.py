"""Seeds of the benchmark's generators, derived from ``--seed``."""

from __future__ import annotations

import hashlib

import torch


def generator(device, seed, *parts):
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and ``parts``
    (a field's name, a rank): distinct streams, one run's data the same for
    the same seed."""
    key = ":".join(str(p) for p in (seed, *parts)).encode()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1)
    return g
