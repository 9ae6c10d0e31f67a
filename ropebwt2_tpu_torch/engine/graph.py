"""A batch's rounds, and on the card their CUDA graphs: the port's
counterpart of the JAX package's compiled batch loop
(ropebwt2_tpu/engine/bcr.py:575-683, bcr_batch_deferred_impl's nested
fori_loops under the jitted bcr_batch, "one device dispatch per batch
instead of one per symbol column").

Every batch of a TorchBwt runs here, on the engine's own ``Runner``.  The
runner holds what a round reads or writes and that outlives it: the read
states, the batch's read buffer (for a deferred flat or packed batch a
power of two, at least the batch's), the round ``d`` (a 0-dim tensor
that each round adds one to) and the pending index (two plane pairs, its
count table and p, made once per pending capacity).  A deferred round is plan_round and pending_add; a
window of R rounds ends in a flush (kernel A or C, or the run tier's
insertion); with R = 0 each round is merged into the base at once.

A deferred batch on the flat or the packed tier writes the index in
place: the runner's own copy of it (``bind`` copies an index that it was
given, so that an index made elsewhere is never written), its totals
added to in place and the flush's merged buffer and tables copied back
(bcr._store).  Those addresses stay fixed from batch to batch, so on the
card the rounds can be CUDA graphs: a round by its position j in the
window (which fixes the pending bound, kernel B's grid, and the plane
pair it reads: a flush leaves both pairs empty, so a window always starts
on the first), a flush by its window's length (the last window of a
batch may be short).  A round merged at once (R = 0) and the run tier
(whose flush sizes its tensors on the host) replace the index's tensors
instead, op by op, as the JAX package's eager engine does.

Graphs are kept while the configuration holds (config_key: the tier and
the index's shapes, K, the order, R, pcap, the batch's lanes and read
buffer) and dropped when it changes.  A configuration's first batch runs
op by op; its graphs are captured in the second batch with the same
configuration and replayed from then on.  So a batch that is the only
one of its configuration (an index grown by every batch, as the CLI's
unplanned ``-m`` batches grow it, or a fresh engine's one batch) pays no
capture, and a planned index replays from its second batch.  A captured
batch runs on the runner's own stream, after what the current stream
holds and before what it gets next (graphs launched into the legacy
default stream left the card idle before each one).  Every graph of a
runner shares one memory pool; nothing that a round or a flush allocates
outlives it, so a capture reuses what the one before it freed.

The capture is cut at every span's entry and exit (trace.cutting) into
one graph per span step, and a replay runs each graph inside its span, so
the spans keep their names and their device time.  Each graph records
the kernel launches it holds (utils/launches.py), and each replay adds
them to the wrappers' counts.  A capture that fails (an operation that
waits on the host among them) raises; nothing falls back to running op by
op.  ``graphs=False``, and the CPU, run every batch op by op."""

import dataclasses
import functools
import time
import warnings

import torch

from ..index.pending import PendingIndex, empty_pending
from ..utils import launches, trace
from . import bcr

# torch's warning at the end of a capture that recorded no work
EMPTY = "The CUDA Graph is empty"
BUF_MIN = 1 << 12  # the smallest read buffer of a runner


def config_key(state, *, K, so, R, pcap, mpad, nbuf):
    """Everything a runner's graphs bake in: the tier and the shape and
    dtype of every tensor of the index, K, the sorting order, R and the
    pending capacity, the batch's lanes and its read buffer's size."""
    shapes = tuple((f.name, tuple(getattr(state, f.name).shape),
                    getattr(state, f.name).dtype)
                   for f in dataclasses.fields(state))
    return (type(state).__name__, shapes, K, so, R, pcap, mpad, nbuf)


def _copied(state):
    """``state`` with each of its tensors copied."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if torch.is_tensor(getattr(state, f.name))})


class Runner:
    """One engine's batches; see the module's docstring.  ``graphs``: on a
    card, replay the deferred batches of the flat and the packed tier as
    CUDA graphs (never on the CPU)."""

    def __init__(self, device, graphs=True):
        self.device = torch.device(device)
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self.stream = None
        # over the runner's life: tapes and graphs captured, segments
        # without work, seconds spent capturing
        self.stats = {"tapes": 0, "graphs": 0, "empty": 0, "capture_s": 0.0}
        self.state = None  # the index, as the last batch left it
        self.owned = False  # whether every tensor of state is the runner's
        self.key = None
        self.repeat = False  # whether the batch's key is the last batch's
        self.reads = self.buf = self.d = None
        self.pcap = None
        self.pairs = self.pblk = self.pp = None
        self.release()

    def release(self):
        """Drop the graphs."""
        self.key = None
        self.tapes = {}
        self.pool = None

    def bind(self, state, *, K, so, R, pcap, mpad, nbuf):
        """Make ``state`` the index of the next batch, of ``mpad`` lanes and
        a read buffer of ``nbuf`` symbols, with R and pcap: the index the
        last batch left (``state`` itself), or else a new one, whose
        graphs are dropped.  A deferred batch on the flat or the packed
        tier gets the runner's own copy of an index it did not make."""
        fixed = R > 0 and not isinstance(state, bcr.RunBwt)
        if fixed:  # batches of nearby sizes share a buffer and its graphs
            nbuf = max(BUF_MIN, 1 << max(nbuf - 1, 0).bit_length())
        key = config_key(state, K=K, so=so, R=R, pcap=pcap, mpad=mpad,
                         nbuf=nbuf)
        if state is not self.state:
            self.release()
            self.state, self.owned = state, False
        self.repeat = key == self.key
        if not self.repeat:
            self.release()
            self.key = key
        self.K, self.so, self.R, self.mpad = K, so, R, mpad
        self.fixed = fixed
        if self.fixed and not self.owned:
            self.state, self.owned = _copied(self.state), True
        dev = self.device
        if self.reads is None or self.reads.l.shape[0] != mpad:
            self.reads = bcr.ReadStates(
                *(torch.empty(mpad, dtype=torch.int64, device=dev)
                  for _ in range(3)))
        if self.buf is None or self.buf.shape[0] != nbuf:
            self.buf = torch.zeros(nbuf, dtype=torch.int8, device=dev)
        if self.d is None:
            self.d = torch.zeros((), dtype=torch.int64, device=dev)
        if R > 0 and pcap != self.pcap:
            self.pairs = self.pblk = self.pp = None
            pend = empty_pending(pcap, dev)
            self.pairs = [(pend.vp, pend.psym), pend.spare]
            self.pblk, self.pp, self.pcap = pend.blk_prefix, pend.p, pcap
        return self.state

    # --- a batch

    def run(self, l, u, pk, buf, n_rounds: int):
        """Every round of a batch (numpy read states and read buffer, as
        TorchBwt._run_batch lays them out) on the bound index; returns
        the index.  A batch whose configuration repeats the last one's is
        replayed as CUDA graphs where the runner has them (see the
        module's docstring)."""
        if not (self.graphs and self.fixed and self.repeat):
            return self._run(l, u, pk, buf, n_rounds, False)
        cur = torch.cuda.current_stream(self.device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self._run(l, u, pk, buf, n_rounds, True)
        cur.wait_stream(self.stream)
        return out

    def _run(self, l, u, pk, buf, n_rounds: int, graphs: bool):
        r = self.reads
        for dst, src in zip((r.l, r.u, r.pk), (l, u, pk)):
            dst.copy_(torch.from_numpy(src))
        self.buf[: buf.shape[0]].copy_(torch.from_numpy(buf))
        self.d.zero_()
        if self.R == 0:
            for _ in range(n_rounds):
                self._merged_round()
        else:
            for lo in range(0, n_rounds, self.R):
                n = min(self.R, n_rounds - lo)
                for j in range(n):
                    self._group(("round", j),
                                functools.partial(self._round, j), graphs)
                self._group(("flush", n), functools.partial(self._flush, n),
                            graphs)
        if not self.fixed:
            self.owned = False
        return self.state

    def _pend(self, j: int) -> PendingIndex:
        """The pending index as the j-th round of a window reads it."""
        cur, spare = self.pairs[j % 2], self.pairs[(j + 1) % 2]
        return PendingIndex(vp=cur[0], psym=cur[1], blk_prefix=self.pblk,
                            p=self.pp, spare=spare,
                            bound=min(self.pcap, j * self.mpad))

    def _commit(self, rd, ins_bucket, n_ins):
        """A round's read states and totals: written back in place on a
        batch that writes the index in place, else the new tensors."""
        st = self.state
        if self.fixed:
            r = self.reads
            for dst, src in zip((r.l, r.u, r.pk), (rd.l, rd.u, rd.pk)):
                dst.copy_(src)
            st.n.add_(n_ins)
            st.psize.add_(ins_bucket.sum(1))
            st.pcounts.add_(ins_bucket)
        else:
            self.reads = rd
            self.state = dataclasses.replace(
                st, n=st.n + n_ins, psize=st.psize + ins_bucket.sum(1),
                pcounts=st.pcounts + ins_bucket)
        self.d.add_(1)

    def _round(self, j: int):
        """Round j of a window: its insertions go to the pending index."""
        st, pend = self.state, self._pend(j)
        with trace.span("round"):
            rd, gX, sym, stream, active, ins_bucket, n_ins = bcr.plan_round(
                st.psize, st.pcounts, self.reads, self.buf, self.d, None,
                bcr._virtual_rank_fn(st, pend, self.K), so=self.so)
            new = bcr.pending_add(pend, gX, sym, stream, active)
            self.pblk.copy_(new.blk_prefix)
            self.pp.copy_(new.p)
            self._commit(rd, ins_bucket, n_ins)

    def _flush(self, n: int):
        """The flush after a window of n rounds."""
        st = self.state
        merged, _ = bcr._flush_pending(st, self._pend(n), K=self.K,
                                       into=st if self.fixed else None)
        self.state = merged

    def _merged_round(self):
        """A round merged straight into the base (R = 0: kernel A or C, or
        the run tier's insertion)."""
        st = self.state
        with trace.span("round"):
            rd, gX, sym, stream, active, ins_bucket, n_ins = bcr.plan_round(
                st.psize, st.pcounts, self.reads, self.buf, self.d, None,
                bcr._state_rank_fn(st, self.K), so=self.so)
            with trace.span("flush"):
                self.state = bcr._state_merge(st, gX, sym, stream, active,
                                              st.n, self.K)
            self._commit(rd, ins_bucket, n_ins)

    # --- graphs

    def _group(self, key, body, graphs: bool):
        """body() (a round or a flush): op by op, or as the replay of its
        tape, captured on first use."""
        if not graphs:
            body()
            return
        tape = self.tapes.get(key)
        if tape is None:
            tape = self.tapes[key] = self._capture(body)
        tape.replay()

    def _capture(self, body):
        """body()'s tape, recorded on the current stream (run's)."""
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        if self.pool is None:
            # the blocks that the configuration's first batch (op by op)
            # left cached would sit beside the graphs' pool, which cannot
            # use them: give them back first
            torch.cuda.empty_cache()
            self.pool = torch.cuda.graph_pool_handle()
        tape = _Tape(self.pool)
        try:
            tape.record(body)
        except BaseException:
            self.release()
            raise
        self.stats["tapes"] += 1
        self.stats["graphs"] += len(tape.graphs)
        self.stats["empty"] += len(tape.kept) - len(tape.graphs)
        self.stats["capture_s"] += time.perf_counter() - t0
        return tape


class _Tape:
    """The CUDA graphs of one round or flush, one for each stretch between
    two span boundaries that holds work, with the span entries and exits
    between them."""

    def __init__(self, pool):
        self.pool = pool
        self.events = []  # ("graph", i) or ("span", name, entering)
        self.graphs = []  # (graph, recorded launches) that hold work
        self.kept = []  # every graph captured (each keeps the pool alive)
        self.g = self.counts = None

    def record(self, body):
        self._begin()
        try:
            with trace.cutting(self._cut):
                body()
        except BaseException:
            self._abort()
            raise
        self._end()

    def _begin(self):
        self.counts = {}
        launches.recording(self.counts)
        self.g = torch.cuda.CUDAGraph()
        self.g.capture_begin(pool=self.pool,
                             capture_error_mode="thread_local")

    def _end(self):
        g, self.g = self.g, None
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                g.capture_end()
        finally:
            launches.recording(None)
        empty = False
        for w in seen:
            if EMPTY in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        self.kept.append(g)
        if not empty:
            self.events.append(("graph", len(self.graphs)))
            self.graphs.append((g, tuple(self.counts.values())))

    def _cut(self, name, entering):
        self._end()
        self.events.append(("span", name, entering))
        self._begin()

    def _abort(self):
        g, self.g = self.g, None
        launches.recording(None)
        if g is not None:
            try:
                g.capture_end()
            except Exception:  # the capture was invalidated: end it only
                pass

    def replay(self):
        if not trace.collecting():
            for g, counts in self.graphs:
                g.replay()
                launches.replayed(counts)
            return
        open_spans = []
        for ev in self.events:
            if ev[0] == "graph":
                g, counts = self.graphs[ev[1]]
                g.replay()
                launches.replayed(counts)
            elif ev[2]:
                sp = trace.span(ev[1])
                sp.__enter__()
                open_spans.append(sp)
            else:
                open_spans.pop().__exit__(None, None, None)
