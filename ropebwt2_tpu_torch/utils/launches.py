"""The kernels' launch counts, eager and in CUDA graphs: the one way in
which every wrapper of a build kernel counts a launch.

A wrapper calls ``launched(counts, key)`` right after it launches its
kernel, with the dict that holds its count (its module's ``globals()``
for a module-level ``LAUNCHES`` int, or its ``LAUNCHES`` dict).  Eagerly
that adds one to ``counts[key]`` and to ``trace.count("launches")``.
While the current stream captures a CUDA graph with a recording set by
``recording`` (engine/graph.py), the launch goes to that recording
instead, and each replay of the graph adds what it recorded through
``replayed``.  A capture with none set (the probes time kernels in
graphs of their own) counts nothing, then or at a replay."""

import torch

from . import trace

_rec = None  # {(id(counts), key): [counts, key, n]} of the graph captured


def launched(counts: dict, key: str = "LAUNCHES"):
    """Count one launch of the kernel whose count is counts[key]."""
    if torch.cuda.is_current_stream_capturing():
        if _rec is not None:
            e = _rec.get((id(counts), key))
            if e is None:
                _rec[(id(counts), key)] = [counts, key, 1]
            else:
                e[2] += 1
        return
    counts[key] += 1
    trace.count("launches")


def recording(rec):
    """Send the launches captured from now on to ``rec`` (a dict, which
    ``tuple(rec.values())`` turns into replayed()'s argument), or nowhere
    (None); returns the recording it replaces."""
    global _rec
    prev, _rec = _rec, rec
    return prev


def replayed(recorded):
    """Add a graph's recorded launches ([counts, key, n] entries), as one
    replay of it launches them."""
    total = 0
    for counts, key, n in recorded:
        counts[key] += n
        total += n
    if total:
        trace.count("launches", total)
