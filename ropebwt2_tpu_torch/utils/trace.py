"""Named spans and counters inside the port, recorded only inside
``collect()``.

    from ropebwt2_tpu_torch.utils import trace

    with trace.collect() as tr:
        eng.insert_multi(reads)
    tr["round"]["host_self_ms"], tr["plan.rank"]["counters"]["launches"]

``span(name)`` marks a step of the program: a name of ``SPANS``, where a
dotted name is a step inside the span its prefix names.  ``count(name,
n)`` adds to a counter (``COUNTERS``) of the innermost open span.  Outside
``collect()`` (and ``cutting()``, below) both return after a check of
module globals: ``span`` gives one shared no-op context (no profiler range, no clock read, no
allocation), so the timed windows of the benchmark, which never run
inside ``collect()``, pay nothing measurable.

Inside ``collect()`` a span opens a profiler range of its name (torch's
RecordFunction, once torch is imported), so that a profiler sees it; adds
the host time from its entry to its exit (perf_counter_ns) to its name,
inclusive and self (less its child spans); and adds one to its calls.
The kernels' wrappers count ``launches`` where they launch, and
``collect()`` counts ``host_reads``: every operation that makes the host
wait for the card (torch.cuda's sync debug mode, set to "warn" from the
first span after the card is initialised; a read of a device value, or a
copy from pageable host memory).  A count outside every span goes to
``UNSPANNED``.  A span takes no tensor and reads nothing from the device.

``cutting(hook)`` makes every span call hook(name, True) at its entry and
hook(name, False) at its exit, inside ``collect()`` or not: the graph
runner (engine/graph.py) cuts the capture of a round into one CUDA graph
per span step there.

The ``Trace`` that ``collect()`` yields is a plain dict, filled when the
block ends: ``{name: {"calls", "host_ms", "host_self_ms", "counters":
{counter: n}}}`` for each span that ran.  With ``log`` (a list) it also
appends ``(time.time_ns(), innermost open span or None)`` at every entry
and exit, on the clock of the profiler's host events, from which
``innermost(log)`` names the span that was open at a host time (the
benchmark charges each device op to the span that launched it).

Imports only the standard library, so that it is loaded before torch is
(the command line's and the warm start's ``startup.import``)."""

import bisect
import contextlib
import functools
import sys
import time
import warnings

SPANS = (
    "startup.import", "startup.device", "build.load",
    "cli.read", "cli.insert", "cli.write",
    "batch", "batch.grow", "batch.post", "round",
    "plan", "plan.sort", "plan.groups", "plan.rank", "plan.update",
    "pending.add", "pending.new_rows", "pending.kernel",
    "flush", "merge.insertion_map", "merge.block_prefix", "merge.kernel",
    "merge.tables", "runs.plan_items", "runs.expand", "runs.rebuild_tables",
    "shard.route", "shard.collective", "shard.reshard",
    "query.rank", "query.search",
)
COUNTERS = ("host_reads", "launches")
UNSPANNED = "unspanned"
SYNC_WARNING = "called a synchronizing CUDA operation"
_NAMES = frozenset(SPANS)

_rec = None  # the recorder of the open collect(), or None
_cut = None  # the hook of the open cutting(), or None


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def span(name: str):
    """A context that records one call of the step ``name`` inside
    ``collect()``, and does nothing outside it."""
    if _rec is None and _cut is None:
        return _NOOP
    return _Span(_rec, name)


def collecting() -> bool:
    """Whether a collect() is open."""
    return _rec is not None


@contextlib.contextmanager
def cutting(hook):
    """Within the block, every span calls hook(name, True) at its entry and
    hook(name, False) at its exit (not at an exit by an exception)."""
    global _cut
    prev, _cut = _cut, hook
    try:
        yield
    finally:
        _cut = prev


def spanned(name: str):
    """A decorator: every call of the function is a call of the span
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, n: int = 1):
    """Add n to the counter ``name`` of the innermost open span (inside
    ``collect()``; nothing outside it)."""
    if _rec is not None:
        _rec.add(name, n)


class _Span:
    __slots__ = ("rec", "name", "up", "t0", "child", "rf")

    def __init__(self, rec, name):
        if name not in _NAMES:
            raise ValueError(f"trace.span: {name!r} is not in trace.SPANS")
        self.rec, self.name = rec, name

    def __enter__(self):
        if _cut is not None:
            _cut(self.name, True)
        rec = self.rec
        if rec is None:
            return
        if rec.syncs is None:
            rec.find_torch()
        rf = rec.range
        if rf is not None:  # torch's profiler range, once torch is loaded
            rf = rf(self.name)
            rf.__enter__()
        self.rf = rf
        if rec.log is not None:
            rec.log.append((time.time_ns(), self.name))
        self.up, rec.top = rec.top, self
        self.child = 0
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        if _cut is not None and (not exc or exc[0] is None):
            _cut(self.name, False)
        rec = self.rec
        if rec is None:
            return False
        dt = time.perf_counter_ns() - self.t0
        up = rec.top = self.up
        if up is not None:
            up.child += dt
        acc = rec.ns.get(self.name)
        if acc is None:
            acc = rec.ns[self.name] = [0, 0, 0]
        acc[0] += 1
        acc[1] += dt
        acc[2] += dt - self.child
        if rec.log is not None:
            rec.log.append((time.time_ns(), None if up is None else up.name))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


class _Recorder:
    def __init__(self, log):
        self.ns = {}  # name: [calls, inclusive ns, self ns]
        self.counts = {}  # name: {counter: n}
        self.top = None  # the innermost open span
        self.log = log
        self.torch = None
        self.range = None  # torch's RecordFunction context class
        self.syncs = None  # the sync debug mode to restore, once set

    def find_torch(self):
        """Once torch is imported, its profiler range; once the card is
        initialised, the sync debug mode "warn" (host reads)."""
        torch = self.torch or sys.modules.get("torch")
        if torch is None or not hasattr(torch, "cuda"):  # not imported yet
            return
        if self.torch is None:
            self.torch = torch
            self.range = getattr(torch._C._profiler, "_RecordFunctionFast",
                                 torch.profiler.record_function)
        if torch.cuda.is_initialized():
            self.syncs = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def add(self, counter, n):
        if counter not in COUNTERS:
            raise ValueError(f"trace.count: {counter!r} is not in "
                             f"trace.COUNTERS")
        name = UNSPANNED if self.top is None else self.top.name
        c = self.counts.get(name)
        if c is None:
            c = self.counts[name] = dict.fromkeys(COUNTERS, 0)
        c[counter] += n

    def result(self) -> dict:
        out = {}
        for name, (calls, inc, own) in self.ns.items():
            out[name] = {"calls": calls, "host_ms": inc / 1e6,
                         "host_self_ms": own / 1e6,
                         "counters": dict.fromkeys(COUNTERS, 0)}
        for name, c in self.counts.items():
            out.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                  "host_self_ms": 0.0, "counters": {}})
            out[name]["counters"] = dict(c)
        return out


@contextlib.contextmanager
def collect(log=None):
    """Record every span and counter of the block; yields the Trace (a
    dict, filled when the block ends).  ``log``: a list to which each
    span's entry and exit append (time.time_ns(), the innermost open span
    after it, or None).  Collections do not nest."""
    global _rec
    if _rec is not None:
        raise RuntimeError("trace.collect() is already open")
    rec = _Recorder(log)
    tr = {}
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                rec.add("host_reads", 1)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        _rec = rec
        try:
            yield tr
        finally:
            _rec = None
            while rec.top is not None:  # spans left open
                rec.top.__exit__()
            if rec.syncs is not None:
                rec.torch.cuda.set_sync_debug_mode(rec.syncs)
            tr.update(rec.result())


def innermost(log):
    """A function of a host time (ns) that names the span innermost at it
    by a ``collect`` log, or None outside every span."""
    times = [t for t, _ in log]
    names = [name for _, name in log]

    def at(t_ns):
        i = bisect.bisect_right(times, t_ns) - 1
        return names[i] if i >= 0 else None

    return at


def merged(traces) -> dict:
    """The sum of several Traces (calls, host times and counters)."""
    out = {}
    for tr in traces:
        for name, e in tr.items():
            o = out.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                      "host_self_ms": 0.0,
                                      "counters": dict.fromkeys(COUNTERS,
                                                                0)})
            o["calls"] += e["calls"]
            o["host_ms"] += e["host_ms"]
            o["host_self_ms"] += e["host_self_ms"]
            for k, v in e["counters"].items():
                o["counters"][k] = o["counters"].get(k, 0) + v
    return out
