"""Profiling: the spans of the pipeline's steps, its host counters, a trace
and a timer.

Counterpart of ``xhistogram_tpu.utils.profiling``. Each step of a public
call runs inside ``scope(stage)``, a span named ``xhistogram.<stage>``:

  ``call`` (``core.histogram``, and ``parallel.histogram_sharded``) or
  ``labeled`` (``labeled.histogram``) at the root; under it ``plan`` (the
  route: sharded or not, then the kernel or the plain path), ``edges``
  (resolving the edges and their device thresholds), ``canonicalize`` (the
  inputs as tensors on one device, broadcast and laid out), ``autograd`` (the
  autograd Function around weighted sums), ``cuda_kernel`` (the fused
  kernel's launch) or ``digitize`` and ``bincount`` (the plain path),
  ``all_reduce`` (a sharded call's partial sums) and ``finish``.

A span adds its self time, its duration less the time its child spans
cover, to ``SELF_NS[stage]``: the process's running total in nanoseconds,
on the host clock (``time.perf_counter_ns``). The totals and the counters
below are always kept; read one before and after a stretch of calls and
take the difference. With no ``torch.profiler`` running a span costs two
clock reads and an add under a lock; while one runs, the span also enters a
range of its name on the profiler's own clock, so a trace (``trace``) shows
the card's kernels and idle gaps under the span that was open on the host
(``tools/idle_by_span.py`` sums the gaps by span). The ranges are
``torch._C._profiler._RecordFunctionFast``, the profiler's low-cost
``record_function``, which it records as CPU ops. The root span of each
public call carries the call's id, a count of public calls (``CALLS``), as
its range's argument ``call``. A public call made inside another (the
labeled API calling ``core.histogram``) is part of its caller's call.

``HOST_SYNCS`` counts the times the program blocked the host on the card:
its own reads of a CUDA tensor's values and the torch calls known to read
one inside (``note_syncs``). ``ROUTES`` counts the calls that took each
route (``note_route``): the kernel that ``plan()`` and the method gate
settled on, or ``"scatter"`` for the plain path, once a call.
``WEIGHTED_SLOTS`` counts the weighted launches of the flat-slot kernel
(``csrc/slot.cuh``) by where their sums went (``note_weighted_slot``), and
``ONE_INPUT_OUTPUTS`` the launches of the one_input kernel
(``csrc/one_input.cuh``) by how their output got its every slot
(``note_one_input_output``). ``NARROW_READS`` counts the inputs of 1 or 2
bytes an element that the card's histograms read, by how they were read
(``note_narrow_read``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["scope", "note_syncs", "note_route", "note_weighted_slot",
           "note_one_input_output", "note_narrow_read", "trace", "SELF_NS", "CALLS",
           "HOST_SYNCS", "ROUTES", "WEIGHTED_SLOTS", "ONE_INPUT_OUTPUTS", "NARROW_READS"]

#: the file ``trace`` writes in its log directory
TRACE_FILE = "trace.json"

#: {stage: nanoseconds of self time of its spans in this process}
SELF_NS = {}
#: public calls made in this process (root spans of ``scope(..., call=True)``)
CALLS = 0
#: host syncs on the card in this process (``note_syncs``)
HOST_SYNCS = 0
#: {route: calls in this process that took it} (``note_route``): the kernels
#: of ``ops.cuda_hist.plan`` and ``"scatter"``, the plain path
ROUTES = dict.fromkeys(("one_input", "joint2", "factored", "factored_per_row",
                        "factored_packed", "direct", "scatter"), 0)
#: {where: weighted flat-slot launches in this process whose sums went there}
#: (``note_weighted_slot``): ``"exact"``, float sums kept as exact integers
#: in shared memory; ``"shared"``, sums in their own type in
#: shared memory (one block's, or a cluster's for integer weights);
#: ``"device"``, sums added straight into the output in device memory
WEIGHTED_SLOTS = dict.fromkeys(("exact", "shared", "device"), 0)
#: {how: one_input launches in this process whose output was written so}
#: (``note_one_input_output``): ``"stored"``, blocks that own whole kept rows
#: stored every slot, trash slot included, into an uninitialised output;
#: ``"zeroed"``, the launcher zeroed the output first and blocks added into
#: it (a full reduction, or rows split across column tiles)
ONE_INPUT_OUTPUTS = dict.fromkeys(("stored", "zeroed"), 0)
#: {how: inputs of a 1- or 2-byte stored type read so on the card in this
#: process} (``note_narrow_read``), one an input each kernel launch
#: (``ops.cuda_hist``) or plain digitize (``ops.digitize.digitize_edges``):
#: ``"in_place"``, read at its own width; ``"widened"``, converted to a
#: wider type in device memory first (the plain path)
NARROW_READS = dict.fromkeys(("in_place", "widened"), 0)

_LOCK = threading.Lock()  # guards the totals and counters above
_OPEN = threading.local()  # .spans: this thread's open spans; .call: its call's id
_clock = time.perf_counter_ns
# (name, inputs, {argument: value}); it ends the process on arguments of
# another type, so it is given a str, a tuple and a dict of ints
_range = torch._C._profiler._RecordFunctionFast


class _Span:
    """One open span: ``scope``'s context manager outside ``torch.compile``."""

    __slots__ = ("stage", "call", "start", "children", "range")

    def __init__(self, stage, call):
        self.stage = stage
        self.call = call
        self.children = 0

    def __enter__(self):
        global CALLS
        start = _clock()
        spans = getattr(_OPEN, "spans", None)
        if spans is None:
            spans = _OPEN.spans = []
        if self.call and not any(s.call for s in spans):
            with _LOCK:
                CALLS += 1
                _OPEN.call = CALLS
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            args = {"call": _OPEN.call} if self.call else {}
            self.range = _range(f"xhistogram.{self.stage}", (), args)
            self.range.__enter__()
        spans.append(self)
        self.start = start
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        took = _clock() - self.start
        spans = _OPEN.spans
        spans.pop()
        if spans:
            spans[-1].children += took
        with _LOCK:
            SELF_NS[self.stage] = SELF_NS.get(self.stage, 0) + took - self.children
        return False


def scope(stage, call=False):
    """The span of step ``stage`` of a call: a context manager that adds
    its self time to ``SELF_NS[stage]`` and, while a ``torch.profiler``
    runs, enters the range ``xhistogram.<stage>``. ``call`` marks the root
    span of a public call: outside any other public call it counts one
    call in ``CALLS``, and its range's argument ``call`` is the call's id.
    Under ``torch.compile`` it does nothing."""
    if torch.compiler.is_compiling():
        return contextlib.nullcontext()
    return _Span(stage, call)


def note_syncs(device, n=1):
    """Count ``n`` host syncs on ``device`` in ``HOST_SYNCS``, where the
    program reads values of a tensor there (a CUDA card; nothing elsewhere)."""
    global HOST_SYNCS
    if device.type == "cuda":
        with _LOCK:
            HOST_SYNCS += n


def note_route(kernel):
    """Count one call on ``kernel``'s route in ``ROUTES`` (None: the plain
    path, ``"scatter"``). Under ``torch.compile`` it does nothing, as
    ``scope`` does."""
    if torch.compiler.is_compiling():
        return
    with _LOCK:
        ROUTES[kernel or "scatter"] += 1


def note_weighted_slot(where):
    """Count one weighted flat-slot launch whose sums went to ``where`` (a
    key of ``WEIGHTED_SLOTS``)."""
    with _LOCK:
        WEIGHTED_SLOTS[where] += 1


def note_one_input_output(how):
    """Count one one_input launch whose output was written ``how`` (a key
    of ``ONE_INPUT_OUTPUTS``)."""
    with _LOCK:
        ONE_INPUT_OUTPUTS[how] += 1


def note_narrow_read(how, n=1):
    """Count ``n`` inputs of a 1- or 2-byte stored type read ``how`` (a key
    of ``NARROW_READS``) on the card. Under ``torch.compile`` it does
    nothing, as ``scope`` does."""
    if torch.compiler.is_compiling():
        return
    with _LOCK:
        NARROW_READS[how] += n


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir/trace.json`` (made if missing; an earlier trace there is
    replaced): host activity, and the card's kernels where a CUDA card is
    present. Open it in ui.perfetto.dev or chrome://tracing; the pipeline's
    ``xhistogram.*`` ranges label its steps, each call's root range with the
    call's id (ops' input shapes are recorded, which carries it). Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(os.fspath(log_dir), TRACE_FILE))
