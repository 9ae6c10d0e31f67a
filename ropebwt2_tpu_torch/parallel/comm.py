"""Communication for the BCR plan (counterpart of
ropebwt2_tpu/parallel/comm.py).

``plan_round`` (engine/bcr.py) is written against this small interface, so
that the same algorithm runs on one device (LocalComm: exactly the ops the
single-device plan always ran) and across the ranks of a process group
(ShardComm: the local running sums and flagged-row lookups plus the
carries and boundary rows that the other ranks hold).  The running sums
and lookups are one-dimensional scans and gathers
(index/rank.py::prefix_rows, flagged_rows).  Where the JAX package runs
one SPMD program under shard_map, the port runs one process per shard
under torch.distributed: rank s holds the LOCAL block of every (M,) or
(M, C) read-state array, rows [s * ml, (s + 1) * ml) of the global batch.

The JAX collectives map one for one: axis_index -> the group rank; psum ->
all_reduce; all_gather -> all_gather_single (all_gather_into_tensor where
the installed torch has no all_gather_single); all_to_all ->
all_to_all_single with equal splits; ppermute to a neighbour ->
batch_isend_irecv.  A re-shard, where the JAX engine places the host copy
of the BWT with a NamedSharding, is all_to_all_single with uneven splits
(exchange_ranges).  Every call is issued by every rank in the same order,
and none reads a value back to the host, so a rank's round loop never
waits on its device.

The routed exchange ships the full Q slots of every (source, target) pair:
the JAX package's slot-capped fast path picks its branch with a psum'd
overflow count on the device, which a host loop could only follow by
reading it back each exchange.
"""

import torch
import torch.distributed as dist

from ..alphabet import NSYM
from ..index.rank import flagged_rows, prefix_rows

_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class LocalComm:
    """One device: exactly the ops of the single-device plan."""

    def iota(self, m, device):
        return torch.arange(m, device=device)

    def sort(self, key, arrays):
        """The arrays in the stable order of ``key``."""
        perm = torch.argsort(key, stable=True)
        return [a[perm] for a in arrays]

    def fetch_syms(self, buf, off):
        """buf[off] (clamped) of the read buffer, as int64."""
        return buf[off.clamp(0, buf.shape[0] - 1)].long()

    def prefix_rows(self, x, dtype):
        """dtype[M + 1, C]: the running sum down the rows of an (M, C) x,
        with a zero row in front."""
        return prefix_rows(x, dtype)

    def last_flagged(self, flag, col, *tables):
        """(h, [t[h, col] for each (M, C) table t]): h[m] is the last row at
        or before m whose flag is set.  The first row's flag must be set."""
        return _take_flagged(flagged_rows(flag), col, tables)

    def next_flagged(self, flag, col, *tables):
        """last_flagged with h[m] the first row at or after m whose flag is
        set.  The last row's flag must be set."""
        return _take_flagged(flagged_rows(flag, after=True), col, tables)

    def roll1(self, x):
        return torch.roll(x, 1)

    def shift_up1(self, x, fill):
        """x[i + 1] at row i; the last row takes ``fill``."""
        return torch.cat([x[1:], x.new_full((1,), fill)])

    def psum_array(self, x):
        return x

    def sum_scalar(self, x):
        return x.sum()


def _take_flagged(h, col, tables):
    """(h, [t[h, col] for t in tables]): one gather a table."""
    return h, [t[h, col] for t in tables]


class ShardComm:
    """One rank of a process group of ``d`` ranks (``group`` None: the
    default group).  Every array argument is this rank's LOCAL block of ml
    rows; every method returns the local block of the GLOBAL result."""

    def __init__(self, group, ml, d):
        self.group = group
        self.ml = ml  # rows per rank
        self.d = d
        self.s = dist.get_rank(group)

    def peer(self, r):
        """The global rank of group rank r (P2P ops address global ranks)."""
        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)

    # ---- iota / reductions ----

    def iota(self, m, device):
        if m != self.ml:
            raise ValueError(f"iota of {m} rows on a rank of {self.ml}")
        return self.s * self.ml + torch.arange(m, device=device)

    def sum_scalar(self, x):
        t = x.sum().reshape(1)
        dist.all_reduce(t, group=self.group)
        return t[0]

    def psum_array(self, x):
        y = x.clone()
        dist.all_reduce(y, group=self.group)
        return y

    def all_gather(self, x):
        """(d, *x.shape): every rank's x, in rank order."""
        x = x.contiguous()
        out = x.new_empty(self.d * x.numel())
        _ALL_GATHER(out, x.reshape(-1), group=self.group)
        return out.view((self.d,) + tuple(x.shape))

    def exchange_ranges(self, out, x, out_splits, in_splits):
        """One all_to_all of uneven ranges: rank t receives the next
        in_splits[t] elements of x, in order, and ``out`` takes
        out_splits[t] elements from each rank t, in order.  The splits are
        host integers on which every rank agrees; a zero sends nothing.
        ``out`` and ``x`` may be views of larger tensors."""
        dist.all_to_all_single(out, x, list(out_splits), list(in_splits),
                               group=self.group)

    # ---- running sums and flagged rows with cross-rank carries ----

    def carry(self, tots):
        """The sum of the (C,) totals of the ranks before this one (zeros
        on the first rank), in the totals' dtype."""
        return self.all_gather(tots)[: self.s].sum(0, dtype=tots.dtype)

    def prefix_rows(self, x, dtype):
        loc = prefix_rows(x, dtype)
        return loc + self.carry(loc[-1])[None, :]

    def _flagged(self, flag, col, tables, after):
        """last_flagged (next_flagged when ``after``) over the global rows:
        the local lookup, and for the rows with no flagged row on their
        side on this rank, the one that the nearest earlier (later) rank
        with a flag holds.  One all_gather a call of this rank's last
        (first) flagged row, global (a row no rank has where there is
        none), and the tables' rows there."""
        base = self.s * self.ml
        h = flagged_rows(flag, after)  # local row, -1 where none
        have = h >= 0
        hc, vals = _take_flagged(h.clamp(min=0), col, tables)
        edge, has = (hc[:1], have[:1]) if after else (hc[-1:], have[-1:])
        none = self.d * self.ml if after else -1
        allt = self.all_gather(torch.cat(
            [torch.where(has, edge + base, none)]
            + [t[edge][0].long() for t in tables]))
        rows = allt[self.s + 1:, 0] if after else allt[: self.s, 0]
        if rows.numel() == 0:  # the first (last) row is flagged here
            return h + base, vals
        # the nearest rank with a flag holds the least (greatest) row
        src = rows.argmin() + self.s + 1 if after else rows.argmax()
        far = allt.index_select(0, src.reshape(1))[0]
        out, at = [], 1
        for t, v in zip(tables, vals):
            out.append(torch.where(have, v, far[at:][col].to(t.dtype)))
            at += t.shape[1]
        return torch.where(have, h + base, far[0]), out

    def last_flagged(self, flag, col, *tables):
        return self._flagged(flag, col, tables, after=False)

    def next_flagged(self, flag, col, *tables):
        return self._flagged(flag, col, tables, after=True)

    # ---- the stable bucket sort as a global permutation ----

    def sort(self, key, arrays):
        """The JAX package's counting sort (ropebwt2_tpu/engine/bcr.py:
        230-246): each row's destination in the stable global order of
        ``key`` (values 0..5), then one routed permutation."""
        oh = (key[:, None] == torch.arange(NSYM, device=key.device)).long()
        allt = self.all_gather(oh.sum(0))  # (d, 6) rows per bucket and rank
        tot = allt.sum(0)
        start = torch.cumsum(tot, 0) - tot + allt[: self.s].sum(0)
        excl = prefix_rows(oh, torch.int64)  # rows of each bucket before
        dest = start[key] + excl.gather(1, key[:, None])[:, 0]
        return self.permute(dest, arrays)

    # ---- boundary rows ----

    def _shift(self, row, right):
        """The neighbour's ``row``: the left one's when ``right`` (rank s
        sends to s + 1), else the right one's; zeros where there is none."""
        wire = row.to(torch.uint8) if row.dtype == torch.bool else row
        wire = wire.contiguous()
        out = torch.zeros_like(wire)
        dst, src = (self.s + 1, self.s - 1) if right else \
            (self.s - 1, self.s + 1)
        ops = []
        if 0 <= dst < self.d:
            ops.append(dist.P2POp(dist.isend, wire, self.peer(dst),
                                  self.group))
        if 0 <= src < self.d:
            ops.append(dist.P2POp(dist.irecv, out, self.peer(src),
                                  self.group))
        if ops:  # a world of one has no pair, and the list must not be empty
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return out.to(row.dtype)

    def from_left(self, x):
        """The left neighbour's x (zeros on the first rank)."""
        return self._shift(x, right=True)

    def roll1(self, x):
        return torch.cat([self.from_left(x[-1:]), x[:-1]])

    def shift_up1(self, x, fill):
        nxt = self._shift(x[:1], right=False)
        if self.s == self.d - 1:
            nxt = x.new_full((1,), fill)
        return torch.cat([x[1:], nxt])

    # ---- routed next-symbol fetch (the read buffer sharded by bytes) ----

    def fetch_syms(self, buf, off):
        """buf is this rank's block of the read buffer (sharded by byte
        range); each row's symbol comes from the rank that owns its offset.
        Reads keep their global byte offsets, so routing is a division."""
        lbuf = buf.shape[0]
        tgt = (off // lbuf).clamp(0, self.d - 1)
        _, (roff,), route = self.exchange(tgt, None, [off])
        loc = (roff - self.s * lbuf).clamp(0, lbuf - 1)
        return self.reply(route, buf[loc].long())

    # ---- padded all-to-all routing ----

    def _slots(self, tgt):
        """slot[i]: the rank of row i among the local rows of its target."""
        oh = tgt[:, None] == torch.arange(self.d, device=tgt.device)
        excl = prefix_rows(oh, torch.int64)  # rows of each target before
        return excl.gather(1, tgt[:, None])[:, 0]

    def exchange(self, tgt, valid, payload):
        """Route rows to target ranks (``valid`` None: every row).  payload:
        (Q,) integer arrays.  Returns (recv_valid bool[d * Q], the int64
        payloads received [d * Q] each, route): a receiver sees one Q-slot
        block per source rank, and ``reply`` routes answers back along
        ``route``.  One all_to_all carries every payload and the validity."""
        q = tgt.shape[0]
        slot = self._slots(tgt)
        idx = tgt * q + slot
        if valid is not None:
            idx = torch.where(valid, idx, self.d * q)  # a trash row
        cols = torch.stack([p.long() for p in payload]
                           + [torch.ones_like(tgt)], dim=1)
        send = cols.new_zeros((self.d * q + 1, cols.shape[1]))
        send[idx] = cols
        send = send[: self.d * q]
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return recv[:, -1] != 0, list(recv[:, :-1].unbind(1)), (tgt, slot)

    def reply(self, route, answers):
        """Inverse routing of ``exchange``: ``answers`` (d * Q, ...) are
        indexed like its recv; returns each original row's answer."""
        tgt, slot = route
        answers = answers.contiguous()
        back = torch.empty_like(answers)
        dist.all_to_all_single(back, answers, group=self.group)
        return back[tgt * tgt.shape[0] + slot]

    def permute(self, dest, arrays):
        """Global permutation: local row i moves to global row dest[i];
        every global row receives exactly one.  Returns local blocks."""
        rv, recv, _ = self.exchange(dest // self.ml, None,
                                    list(arrays) + [dest])
        # empty slots go to a trash row
        ldest = torch.where(rv, recv[-1] - self.s * self.ml, self.ml)
        out = []
        for r, a in zip(recv[:-1], arrays):
            o = a.new_empty(self.ml + 1)
            o[ldest] = r.to(a.dtype)
            out.append(o[: self.ml])
        return out
