"""The mesh's ``space`` axis: a process's rows of each sample, and the
collectives that let the module path run on them.

rvdd_tpu shards the patch height over its mesh's ``space`` axis and XLA
inserts the exchanges a convolution, a resample or a warp needs across the
cut (rvdd_tpu/parallel/mesh.py:54-77).  The port writes them out:

* :class:`Rows` describes one resolution of a sample: every shard's
  ``(start, stop)`` rows, this process's index and the group of the space
  axis.  :meth:`Rows.down` and :meth:`Rows.scale` follow a pool or an
  upsample, so a net derives every level's rows from its input's.
* :func:`window` gives a process any range of global rows near its own:
  the rows its neighbours hold (one ``all_gather`` of every shard's edge
  strips, however many shards the range reaches across), and zeros or the
  replicated edge row beyond the sample.  :func:`halo` is its common case:
  ``lo`` rows above and ``hi`` below.  Its backward sends each halo row's
  gradient back to the shard that holds the row.
* :func:`gather_rows` gives every process the whole sample, for the warp,
  whose reach is unbounded.
* :func:`all_sum` sums over a group, with its gradient.

The ops take their :class:`Rows` as an argument (``rows=None``: the
single-process code runs unchanged).  The engine and the nets learn the
shard from :func:`scope`, which the train step and the sharded inference
enter, as rvdd_tpu's code runs under ``with mesh:``; :func:`rows_of` gives
the active rows at a tensor's resolution (the packed raw rows, or twice
them).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: the active scope (a module global, not a thread-local: the autograd
#: engine runs a CUDA backward, and remat's recomputation, on its own thread)
_ACTIVE: list = [None]


@dataclasses.dataclass(frozen=True)
class Rows:
    """The rows of one resolution of a sample over the space axis:
    ``bounds[i]`` are shard i's global ``(start, stop)``, ``index`` is this
    process's shard and ``group`` the space axis's process group."""

    bounds: Tuple[Tuple[int, int], ...]
    index: int
    group: Any = dataclasses.field(default=None, compare=False)

    @property
    def start(self) -> int:
        return self.bounds[self.index][0]

    @property
    def stop(self) -> int:
        return self.bounds[self.index][1]

    @property
    def n(self) -> int:
        """This shard's rows."""
        return self.stop - self.start

    @property
    def height(self) -> int:
        """The sample's rows."""
        return self.bounds[-1][1]

    @property
    def size(self) -> int:
        """The shards of the space axis."""
        return len(self.bounds)

    def scale(self, k: int) -> "Rows":
        """The rows after a x``k`` upsample (every bound times k)."""
        return dataclasses.replace(self, bounds=tuple((a * k, b * k) for a, b in self.bounds))

    def down(self, ceil: bool = False) -> "Rows":
        """The rows after a stride-2 pool, with floor semantics (or ceil,
        flax's 'SAME' stride-2 conv): every cut between shards is even, so
        each shard pools its own rows."""
        cuts = [b for _, b in self.bounds[:-1]]
        if any(c % 2 for c in cuts):
            raise ValueError(f"rows {self.bounds}: a cut between shards is odd, so a pool "
                             "would straddle it")
        h = (self.height + 1) // 2 if ceil else self.height // 2
        return self.with_height(h, tuple((a // 2, b // 2) for a, b in self.bounds))

    def with_height(self, height: int, bounds=None) -> "Rows":
        """The same cuts with the sample ``height`` rows tall (the last
        shard ends there): the rows of an upsample whose output is not
        exactly twice its input, e.g. ``transposedconv3``'s 2h - 1."""
        b = list(bounds if bounds is not None else self.bounds)
        b[-1] = (b[-1][0], height)
        if b[-1][0] >= height:
            raise ValueError(f"rows {tuple(b)}: the last shard holds no row")
        return dataclasses.replace(self, bounds=tuple(b))


def split_rows(height: int, parts: int, align: int = 1, index: int = 0,
               group=None) -> Rows:
    """Cut ``height`` rows into ``parts`` shards of whole blocks of
    ``align`` rows, the first shards taking one block more where they do
    not divide evenly, and the ragged tail (``height % align`` rows) after
    the last shard's blocks, so that no shard runs out of rows at a level
    its blocks reach."""
    blocks = height // align
    if blocks < parts:
        raise ValueError(f"{height} rows hold {blocks} whole block(s) of {align} rows, fewer "
                         f"than the {parts} shards of the space axis")
    q, r = divmod(blocks, parts)
    bounds, start = [], 0
    for i in range(parts):
        stop = height if i == parts - 1 else start + (q + (i < r)) * align
        bounds.append((start, stop))
        start = stop
    return Rows(tuple(bounds), index, group)


# ------------------------------------------------------------ collectives


def _is_nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


class _AllGather(torch.autograd.Function):
    """Every shard's ``x`` (equal shapes), stacked on a new leading axis;
    the backward sums each shard's gradient over the group
    (a reduce-scatter on NCCL; gloo: an all-reduce of the whole, then this
    shard's part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        m = dist.get_world_size(group)
        if _is_nccl(group):
            out = torch.empty((m,) + tuple(x.shape), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x, group=group)
            return out
        parts = [torch.empty_like(x) for _ in range(m)]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        if _is_nccl(group):
            g = g.contiguous()
            out = torch.empty(g.shape[1:], dtype=g.dtype, device=g.device)
            dist.reduce_scatter_tensor(out, g, group=group)
            return out, None
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return g[dist.get_rank(group)], None


class _AllSum(torch.autograd.Function):
    """The sum over the group; its gradient is the sum of the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, differentiable."""
    return _AllSum.apply(t, group)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every process's ``t`` (equal shapes) stacked [M, ...], differentiable."""
    return _AllGather.apply(t, group)


# ------------------------------------------------------------ row exchanges


def _pad_rows(x: torch.Tensor, k: int, front: bool) -> torch.Tensor:
    """x (rows on axis 0) padded with zero rows to ``k`` rows (always by a
    ``cat``, even of no rows: see :func:`window`)."""
    z = x.new_zeros((k - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([z, x] if front else [x, z])


@functools.lru_cache(maxsize=4096)
def _index(idx: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A window's row indices on its device, copied there once (every step
    repeats the same windows)."""
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def _source(rows: Rows, g: int, k: int) -> int:
    """The slot of global row ``g`` in the gathered edge strips (each
    shard's first k rows, then its last k)."""
    for q, (a, b) in enumerate(rows.bounds):
        if a <= g < b:
            if g - a < k:
                return q * 2 * k + (g - a)
            if b - g <= k:
                return q * 2 * k + 2 * k - (b - g)
            raise AssertionError(f"row {g} lies deeper than {k} rows in shard {q}")
    raise AssertionError(f"row {g} is outside the sample")


def window(x: torch.Tensor, rows: Rows, want: Sequence[Tuple[int, int]],
           fill: str = "zero", dim: int = -3) -> torch.Tensor:
    """Global rows ``[a, b)`` of the sample, ``(a, b) = want[rows.index]``,
    from this shard's ``x`` (its ``rows.n`` rows on axis ``dim``) and its
    neighbours'.  Every process of the space axis calls it with the same
    ``want`` (one range a shard).  Rows beyond the sample are zeros
    (``fill='zero'``) or the nearest edge row (``'edge'``).  One
    ``all_gather`` of every shard's first and last k rows, k the deepest
    that any range reaches into another shard, or none where every range
    lies in its own shard and the fill.

    The collectives of the backward run in the order the autograd engine
    reaches them, which follows the graph, so every shard builds the same
    graph: no branch here depends on this shard's own rows (a shard that
    needs no halo row still selects none from the gathered strips)."""
    if x.shape[dim] != rows.n:
        raise ValueError(f"a shard of {x.shape[dim]} rows on axis {dim}, its rows say {rows.n}")
    if fill not in ("zero", "edge"):
        raise ValueError(f"unknown fill {fill!r}")
    h = rows.height

    def source_row(g):  # the row that global row g reads, or None (a zero)
        if 0 <= g < h:
            return g
        return None if fill == "zero" else min(max(g, 0), h - 1)

    k = 0
    for (a, b), (s, e) in zip(want, rows.bounds):
        for g in list(range(a, min(b, s))) + list(range(max(a, e), b)):
            src = source_row(g)
            if src is None or s <= src < e:
                continue
            for qa, qb in rows.bounds:
                if qa <= src < qb:
                    k = max(k, min(src - qa + 1, qb - src))
    a, b = want[rows.index]
    s, e = rows.start, rows.stop
    x0 = x.movedim(dim, 0)
    n = x0.shape[0]
    # the pool a halo row is read from: this shard's first and last rows
    # (the replicated edge of a shard at the sample's edge), the gathered
    # strips, a zero row
    pieces = [x0[:1], x0[-1:]]
    if k:
        t = min(k, n)
        strips = torch.cat([_pad_rows(x0[:t], k, False), _pad_rows(x0[n - t:], k, True)])
        pieces.append(all_gather(strips, rows.group).flatten(0, 1))
    pieces.append(x0.new_zeros((1,) + tuple(x0.shape[1:])))
    zero = sum(p.shape[0] for p in pieces) - 1

    def index(gs):
        idx = []
        for g in gs:
            src = source_row(g)
            if src is None:
                idx.append(zero)
            elif s <= src < e:  # the clamp onto this shard's edge row
                idx.append(0 if src == s else 1)
            else:
                idx.append(2 + _source(rows, src, k))
        return _index(tuple(idx), x.device)

    mid = x0[max(a, s) - s:max(min(b, e) - s, 0)]
    if not k and all(wa >= ws and wb <= we for (wa, wb), (ws, we) in zip(want, rows.bounds)):
        return mid.movedim(0, dim)  # every range is its shard's own rows or fewer
    pool = torch.cat(pieces)
    lo = pool.index_select(0, index(range(a, min(b, s))))
    hi = pool.index_select(0, index(range(max(a, e), b)))
    return torch.cat([lo, mid, hi]).movedim(0, dim)


def halo(x: torch.Tensor, rows: Rows, lo: int, hi: int, fill: str = "zero",
         dim: int = -3) -> torch.Tensor:
    """This shard's rows with ``lo`` rows above and ``hi`` below
    (:func:`window`)."""
    return window(x, rows, [(a - lo, b + hi) for a, b in rows.bounds], fill, dim)


def gather_rows(x: torch.Tensor, rows: Rows, dim: int = -3) -> torch.Tensor:
    """The whole sample on every shard (each shard padded to the largest
    for the ``all_gather``), differentiable."""
    m = max(b - a for a, b in rows.bounds)
    x0 = x.movedim(dim, 0)
    parts = all_gather(_pad_rows(x0, m, False), rows.group)
    whole = torch.cat([parts[q, :b - a] for q, (a, b) in enumerate(rows.bounds)])
    return whole.movedim(0, dim)


# ------------------------------------------------------------ the scope


@dataclasses.dataclass(frozen=True)
class Scope:
    """What the module path needs to know of the mesh: this process's
    rows of the packed raw frames (None without a space axis) and the group
    that batch statistics span (the whole mesh; None: this process's
    rows)."""

    rows: Optional[Rows] = None
    batch_group: Any = None


@contextlib.contextmanager
def scope(rows: Optional[Rows] = None, batch_group=None):
    """Run the engine and the nets on this shard: the train step's forward
    and backward, or a sharded inference step."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = Scope(rows, batch_group)
    try:
        yield _ACTIVE[0]
    finally:
        _ACTIVE[0] = prev


def active() -> Optional[Scope]:
    return _ACTIVE[0]


def rows_of(x: torch.Tensor, dim: int = -3) -> Optional[Rows]:
    """The active rows at ``x``'s resolution: those of the packed raw
    frames, or twice them (the demosaicked frames, the net's input); None
    without a space axis."""
    sc = _ACTIVE[0]
    if sc is None or sc.rows is None:
        return None
    n = x.shape[dim]
    for k in (1, 2):
        if n == k * sc.rows.n:
            return sc.rows.scale(k)
    raise ValueError(f"a tensor of {n} rows on axis {dim} in a scope whose shard holds "
                     f"{sc.rows.n} raw rows")
