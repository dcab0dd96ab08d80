"""Named spans at the port's layer boundaries, recorded while
``torch.profiler`` records.

``with span("recon.forward"): ...`` costs one flag read when no profiler
session is recording: it returns one shared null context and records
nothing.  While a session records, it opens
``torch.profiler.record_function("gshell.recon.forward")``, so the span
shows in the session's events and in any exported Chrome trace, and
appends a :class:`Record` to a bounded in-memory log that
:func:`recorded` returns.  There is no other switch.

A record's times are on the clock the profiler stamps its events with
(``time.time_ns()``), so records can be laid over the device trace of the
same session.  Its parent is the innermost span open on the same thread;
a span opened on a thread that has none open (autograd's device worker
running a backward, and the recomputation of a checkpointed region there)
takes the most recently opened of the other threads' innermost open
spans: that of the thread waiting in ``backward()``.

:func:`span_backward` spans the backward of a stretch of the forward: each
autograd node between its outputs and its inputs, while the node runs."""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

from torch.autograd import profiler as _profiler

PREFIX = "gshell."
CAPACITY = 65536  # records kept; the oldest go first


class Record(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent_id: Optional[int]


_OFF = contextlib.nullcontext()
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_open: dict = {}  # thread ident → that thread's open spans, innermost last: [(id, start_ns)]

# A process's first record_function binds its classes (~1 ms) after the
# profiler has stamped its start; bound here, outside any session, a
# span's record lies within microseconds of its annotation.
with _profiler.record_function(PREFIX + "bind"):
    pass


class _Span:
    __slots__ = ("name", "annotation", "id", "parent", "start", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.stack = _open.setdefault(threading.get_ident(), [])
        if self.stack:
            self.parent = self.stack[-1][0]
        else:
            tops = [s[-1] for s in list(_open.values()) if s]
            self.parent = max(tops, key=lambda t: t[1])[0] if tops else None
        self.annotation = _profiler.record_function(PREFIX + self.name)
        self.annotation.__enter__()
        self.id = next(_ids)
        self.start = time.time_ns()
        self.stack.append((self.id, self.start))
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        # both ends stamped after record_function returns: it spends less
        # time after its own stamp than before it
        end = time.time_ns()
        self.stack.pop()
        _records.append(Record(self.id, self.name, self.start, end, self.parent))
        return False


def span(name: str):
    """A context manager: the span ``name`` while a profiler session
    records, else a shared null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def recording() -> bool:
    """Whether a profiler session records (and spans with it)."""
    return bool(_profiler._is_profiler_enabled)


def span_backward(name: str, outputs, inputs) -> None:
    """While a profiler session records: the span ``name`` around every
    autograd node that lies between the tensors ``outputs`` and the tensors
    ``inputs`` (the backward of the operations that made the one from the
    other), opened as the node starts and closed as it returns, on the
    thread that runs it.  Nodes that the backward never reaches record
    nothing.  Off the profiler it does nothing."""
    if not _profiler._is_profiler_enabled:
        return
    stop = {t.grad_fn for t in inputs if t.grad_fn is not None}
    open_spans = []

    def enter(grad_outputs):
        open_spans.append(_Span(name).__enter__())

    def leave(grad_inputs, grad_outputs):
        open_spans.pop().__exit__(None, None, None)

    seen, todo = set(), [t.grad_fn for t in outputs if t.grad_fn is not None]
    while todo:
        node = todo.pop()
        # a leaf input's node accumulates its gradient: the forward's stretch ends there
        if node is None or node in seen or node in stop or type(node).__name__ == "AccumulateGrad":
            continue
        seen.add(node)
        node.register_prehook(enter)
        node.register_hook(leave)
        todo.extend(f for f, _ in node.next_functions)


def recorded() -> list:
    """The records kept, in the order the spans ended."""
    return list(_records)
