"""Communication for the BCR plan (counterpart of
ropebwt2_tpu/parallel/comm.py).

``plan_round`` (engine/bcr.py) is written against this small interface, so
that the same algorithm runs on one device (LocalComm: exactly the ops the
single-device plan always ran) and across the ranks of a process group
(ShardComm: local scans plus the carries and boundary rows that the other
ranks hold).  Where the JAX package runs one SPMD program under shard_map,
the port runs one process per shard under torch.distributed: rank s holds
the LOCAL block of every (M,) or (M, C) read-state array, rows
[s * ml, (s + 1) * ml) of the global batch.

The JAX collectives map one for one: axis_index -> the group rank; psum ->
all_reduce; all_gather -> all_gather_single (all_gather_into_tensor where
the installed torch has no all_gather_single); all_to_all ->
all_to_all_single with equal splits; ppermute to a neighbour ->
batch_isend_irecv.  Every call is issued by every rank in the same order,
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
from ..index.rank import scan_rows

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

    def scan(self, op, x, reverse=False):
        """op (torch.cumsum / cummax / cummin) down the rows of x, from the
        last row up when ``reverse``."""
        if reverse:
            return scan_rows(op, x.flip(0)).flip(0)
        return scan_rows(op, x)

    def roll1(self, x):
        return torch.roll(x, 1)

    def shift_up1(self, x, fill):
        """x[i + 1] at row i; the last row takes ``fill``."""
        return torch.cat([x[1:], x.new_full((1,), fill)])

    def psum_array(self, x):
        return x

    def sum_scalar(self, x):
        return x.sum()


# combine and identity of each scan's carry
_COMBINE = {
    torch.cumsum: (torch.add, lambda dt: 0),
    torch.cummax: (torch.maximum, lambda dt: torch.iinfo(dt).min),
    torch.cummin: (torch.minimum, lambda dt: torch.iinfo(dt).max),
}


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

    # ---- scans with cross-rank carries ----

    def carry(self, tots, op, reverse=False):
        """op's combine of the (C,) totals of the ranks before this one
        (after it when ``reverse``); the identity on the first rank."""
        combine, ident = _COMBINE[op]
        allt = self.all_gather(tots)
        sel = allt[self.s + 1:] if reverse else allt[: self.s]
        out = tots.new_full(tots.shape, ident(tots.dtype))
        for row in sel:
            out = combine(out, row)
        return out

    def scan(self, op, x, reverse=False):
        squeeze = x.dim() == 1
        x2 = x[:, None] if squeeze else x
        if reverse:
            loc = scan_rows(op, x2.flip(0)).flip(0)
            base = self.carry(loc[0], op, reverse=True)
        else:
            loc = scan_rows(op, x2)
            base = self.carry(loc[-1], op)
        out = _COMBINE[op][0](loc, base[None, :])
        return out[:, 0] if squeeze else out

    # ---- the stable bucket sort as a global permutation ----

    def sort(self, key, arrays):
        """The JAX package's counting sort (ropebwt2_tpu/engine/bcr.py:
        230-246): each row's destination in the stable global order of
        ``key`` (values 0..5), then one routed permutation."""
        oh = (key[:, None] == torch.arange(NSYM, device=key.device)).long()
        allt = self.all_gather(oh.sum(0))  # (d, 6) rows per bucket and rank
        tot = allt.sum(0)
        start = torch.cumsum(tot, 0) - tot + allt[: self.s].sum(0)
        csum = scan_rows(torch.cumsum, oh)
        dest = start[key] + csum.gather(1, key[:, None])[:, 0] - 1
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
        oh = (tgt[:, None] == torch.arange(self.d, device=tgt.device)).long()
        return (scan_rows(torch.cumsum, oh) - 1).gather(1, tgt[:, None])[:, 0]

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
