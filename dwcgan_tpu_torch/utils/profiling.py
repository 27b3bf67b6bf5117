"""Spans: named intervals of the port's host work (the counterpart of
`dwcgan_tpu/utils/profiling.py::annotate`).

    from dwcgan_tpu_torch.utils.profiling import span
    with span("data.next", ready=3):
        ...

Each span records its name, its start and end on `time.perf_counter_ns()`,
its parent (the innermost span open on the same thread, 0 for none), the id
of its root (the outermost open span; every span of one step or one served
batch shares it), the thread, and the small integer counts given to it.
Finished spans are kept in memory, in a bounded ring (`RING` entries,
oldest overwritten first; `Recorder.dropped_since` says whether any span
that ended at or after a time was overwritten) and as per-name totals
(count, nanoseconds).  Nothing is written to disk.

Off, the default: no `torch.profiler` session is recording, and a span
costs two clock reads and one ring append; no `record_function`, no device
sync, no I/O.  On: a profiler session is recording (the benchmark's traced
slice, `cli/train.py --profile_dir`), and each span also opens a
`torch.profiler.record_function(name)`, so it lands in the same Chrome
trace as the operations and kernels, on their clock, as a
`user_annotation` event.

The spans of the program:

- `data.next` (count `ready`: batches decoded and waiting when the consumer
  asked), `data.to_device`: `data/pipeline.py`;
- `train.step` (a root; count `graph`: 1 where the step replayed a CUDA
  graph, 0 where it ran eagerly) holding, on an eager step,
  `train.g_forward`, `train.d_update` (with `train.d_backward` and
  `train.adam_d`), `train.g_update` (with `train.g_backward` and
  `train.adam_g`) and `train.ema`, and on the step that records a graph
  `train.capture` around them: `train/step.py`;
- `gen.encode`, `gen.encode_txt` (count `lstm_kernel`: 1 where the text
  encoder's recurrence runs as the CUDA kernels, 0 where the loop runs),
  `gen.decode`: `models/generator.py`, under whichever span is open;
  `loss.vgg`: `models/vgg.py`;
- `translate.batch` (a root) holding `translate.to_device`:
  `cli/translate.py::translate_batch`;
- `setup.build_trainer` (`cli/train.py`), `setup.build_generator`
  (`models/generator.py`).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Tuple

import torch

RING = 1 << 15

_profiler_on = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """One finished span; times in `perf_counter_ns` nanoseconds."""
    id: int
    name: str
    t0: int
    t1: int
    parent: int        # 0: none
    root: int          # its own id for a root span
    thread: int
    counts: Dict[str, int]


class _Stack(threading.local):
    """One thread's open spans, innermost last."""

    def __init__(self):
        self.open: List["_Open"] = []
        self.thread = threading.get_ident()


class _Open:
    """A span being recorded: `__enter__` begins it, `__exit__` ends it."""

    __slots__ = ("rec", "name", "counts", "id", "parent", "root", "t0", "rf")

    def __init__(self, rec: "Recorder", name: str, counts: Dict[str, int]):
        self.rec, self.name, self.counts = rec, name, counts

    def __enter__(self) -> "_Open":
        rec = self.rec
        stack = rec._stack.open
        self.id = next(rec._ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = 0, self.id
        stack.append(self)
        self.rf = None
        if _profiler_on():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        rec = self.rec
        stack = rec._stack
        stack.open.pop()
        rec.add((self.id, self.name, self.t0, t1, self.parent, self.root,
                 stack.thread, self.counts))
        return False


class Recorder:
    """The ring and the per-name totals of one process's spans."""

    def __init__(self, capacity: int = RING):
        self.capacity = capacity
        self._ring: List[tuple] = [None] * capacity
        self._seq = itertools.count()
        self._ids = itertools.count(1)
        self._stack = _Stack()
        self._totals: Dict[str, List[int]] = {}
        self._dropped_t1 = -1     # the latest end of an overwritten span

    def span(self, name: str, **counts: int) -> _Open:
        """A context manager recording one span named `name`."""
        return _Open(self, name, counts)

    def add(self, s: tuple) -> None:
        """Append a finished span (a `Span` or its fields in order),
        overwriting the oldest when full."""
        slot = next(self._seq) % self.capacity
        old = self._ring[slot]
        if old is not None and old[3] > self._dropped_t1:
            self._dropped_t1 = old[3]
        self._ring[slot] = s
        tot = self._totals.get(s[1])
        if tot is None:
            tot = self._totals[s[1]] = [0, 0]
        tot[0] += 1
        tot[1] += s[3] - s[2]

    def spans(self) -> List[Span]:
        """The spans the ring holds, by start."""
        return sorted((Span._make(s) for s in self._ring if s is not None),
                      key=lambda s: s.t0)

    def dropped_since(self, t_ns: int) -> bool:
        """Whether the ring overwrote a span that ended at or after `t_ns`."""
        return self._dropped_t1 >= t_ns

    def totals(self) -> Dict[str, Tuple[int, int]]:
        """{name: (spans, nanoseconds)} of every span recorded."""
        return {k: (n, ns) for k, (n, ns) in self._totals.items()}


RECORDER = Recorder()
span = RECORDER.span
