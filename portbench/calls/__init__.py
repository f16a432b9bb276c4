"""Call kinds: one module each, found by the ``call`` of a traffic file.

A call kind's ``build(data, traffic, device)`` returns a ``Calls``: the calls
the window cycles through, the public call of the program on each, how to
read its answer, and the reference's answer at the configuration's
precision or, for the control, at a lower one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Calls:
    #: the distinct calls, made in this order, round and round
    items: list
    #: the program's public call on an item; returns its output
    program: Callable[[Any], Any]
    #: {"hist": tensor, "edges": [...], "labels": {...}} of an output
    answer: Callable[[Any], dict]
    #: the reference's answer for an item, its data first rounded to
    #: ``lowp`` when that is a dtype (the control)
    expected: Callable[[Any, Any], dict]
    #: bytes each item's call reads (inputs and weights at their own size)
    #: and writes (its output) on this card
    in_bytes: list
    out_bytes: list
    #: indices of the items whose latest answers are judged
    judged: list


def edges_of(data, traffic):
    return [data[name] for name in traffic["bins"]]


def nbytes(t):
    return t.numel() * t.element_size()
