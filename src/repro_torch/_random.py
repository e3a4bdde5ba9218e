"""Counter-based random draws: Philox4x32-10 (Salmon et al., SC'11) in torch
integer ops.

Every random input of the port comes from here.  A draw is a pure function
of a key (two 32-bit words, taken once from the caller's CPU
``torch.Generator`` at an entry point) and of each value's index, computed
where the counters live: on the card there is no host loop and no copy, and
the CPU computes the same bits.  The uniform, Rademacher and raw-word draws
are bitwise equal on both devices; normals and Gumbels go through
``log``/``cos``/``sin`` and agree to a few ulps.

Counter layout of one Philox block (four 32-bit words out):
``(c0, c1, c2, c3) = (column block, row, draw number, 0)``.  A ``[rows,
cols]`` draw takes row ``row0 + r``'s words from blocks ``0 …
⌈words/4⌉ − 1``, so a row's values depend only on (key, draw, row index),
not on how many rows were drawn with it: chunked draws reproduce one large
draw.  Each draw site takes its own draw number from a :class:`Stream`.

The two 32 × 32 → 64-bit products of a round are formed from 16-bit limbs of
the counter word, so every intermediate stays below 2⁴⁹ and no signed
64-bit product overflows (torch promises no wrap-around for that).  The
counter is held as two ``[2, N]`` int64 tensors, so a round is 14 elementwise
launches and a pass about 150, whatever N; nothing is copied from the host.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers of words 0 and 2
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key schedule (Weyl) increments
ROUNDS = 10

Key = Tuple[int, int]
Shape = Union[int, Sequence[int]]


def key_from_generator(gen: torch.Generator) -> Key:
    """A Philox key: one draw of two 32-bit words from the CPU ``gen`` (which
    advances by that draw)."""
    k0, k1 = torch.randint(0, 1 << 32, (2,), generator=gen, dtype=torch.int64).tolist()
    return int(k0), int(k1)


def _mulhilo(a: torch.Tensor, m: torch.Tensor):
    """(hi, lo) 32-bit halves of ``a · m`` for uint32 values held in int64,
    from the 16-bit limbs of ``a``: each partial product is below 2⁴⁸."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & MASK32


def philox4x32(counter: torch.Tensor, key: Key) -> torch.Tensor:
    """Philox4x32-10 of the counters ``[4, N]`` (uint32 words in int64) under
    ``key``: the ``[4, N]`` output words, on the counters' device."""
    dev = counter.device
    # the round keys and multipliers made where the counters are (a host
    # tensor copied over would synchronise the stream)
    r = torch.arange(ROUNDS, dtype=torch.int64, device=dev)
    sched = torch.stack([(key[0] + r * PHILOX_W[0]) & MASK32,
                         (key[1] + r * PHILOX_W[1]) & MASK32], 1)[..., None]  # [10, 2, 1]
    mult = torch.where(torch.arange(2, device=dev) == 0, PHILOX_M[0], PHILOX_M[1])[:, None]
    a = counter[0::2].clone()  # (c0, c2): the words that are multiplied
    b = counter[1::2].clone()  # (c1, c3)
    for r in range(ROUNDS):
        hi, lo = _mulhilo(a, mult)
        # c0' = hi(c2) ^ c1 ^ k0, c2' = hi(c0) ^ c3 ^ k1, c1' = lo(c2), c3' = lo(c0)
        a = hi.flip(0) ^ b ^ sched[r]
        b = lo.flip(0)
    return torch.stack([a[0], b[0], a[1], b[1]])


def words(key: Key, draw: int, rows: int, cols: int, device, *, row0: int = 0,
          col0: int = 0) -> torch.Tensor:
    """``[rows, cols]`` uint32 words (int64) of draw ``draw``: row ``r`` is
    counter row ``row0 + r``, its words the Philox blocks ``0 …
    ⌈cols/4⌉ − 1`` in order.  With ``col0`` the window of words ``col0 …
    col0 + cols − 1`` of each row, made without the words before it: the
    same bits as those columns of the draw from column 0."""
    skip = col0 // 4
    blocks = -(-(col0 + cols) // 4) - skip
    if skip + blocks >= 1 << 32 or row0 + rows > 1 << 32 or not 0 <= draw < 1 << 32:
        raise ValueError(f"Philox counter range exceeded: {rows} rows from {row0} of "
                         f"{cols} words from {col0}, draw {draw}")
    dev = torch.device(device)
    n = rows * blocks
    ctr = torch.empty((4, n), dtype=torch.int64, device=dev)
    ctr[0] = torch.arange(skip, skip + blocks, dtype=torch.int64, device=dev).repeat(rows)
    ctr[1] = torch.arange(row0, row0 + rows, dtype=torch.int64,
                          device=dev).repeat_interleave(blocks)
    ctr[2] = draw
    ctr[3] = 0
    out = philox4x32(ctr, key)  # [4, rows·blocks]
    first = col0 - 4 * skip
    return out.T.reshape(rows, blocks * 4)[:, first:first + cols]


def _grid(shape: Shape) -> Tuple[Tuple[int, ...], int, int]:
    """(shape, rows, cols) of a 1-D (one row) or 2-D draw."""
    shape = (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)
    if len(shape) == 1:
        return shape, 1, shape[0]
    if len(shape) == 2:
        return shape, shape[0], shape[1]
    raise ValueError(f"draws are 1-D or 2-D, got shape {shape}")


def _unit(w: torch.Tensor) -> torch.Tensor:
    """The top 24 bits of each word × 2⁻²⁴: float32 uniforms on [0, 1), exact."""
    return (w >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _tiny(u: torch.Tensor) -> torch.Tensor:
    return torch.clamp(u, min=torch.finfo(torch.float32).tiny)


def uniform(key: Key, draw: int, shape: Shape, device, *, row0: int = 0,
            col0: int = 0) -> torch.Tensor:
    """float32 uniforms on [0, 1), one word each (``col0``: the columns from
    there, as :func:`words`)."""
    shape, rows, cols = _grid(shape)
    return _unit(words(key, draw, rows, cols, device, row0=row0, col0=col0)).reshape(shape)


def normal(key: Key, draw: int, shape: Shape, device, *, row0: int = 0) -> torch.Tensor:
    """float32 standard normals by Box–Muller: words (2i, 2i + 1) of a row give
    its values 2i (cosine) and 2i + 1 (sine)."""
    shape, rows, cols = _grid(shape)
    w = words(key, draw, rows, cols + cols % 2, device, row0=row0).reshape(rows, -1, 2)
    radius = torch.sqrt(-2.0 * torch.log(_tiny(_unit(w[..., 0]))))
    theta = (2.0 * math.pi) * _unit(w[..., 1])
    z = torch.stack([radius * torch.cos(theta), radius * torch.sin(theta)], -1)
    return z.reshape(rows, -1)[:, :cols].reshape(shape)


def rademacher(key: Key, draw: int, shape: Shape, device, *, row0: int = 0) -> torch.Tensor:
    """float32 ±1, one bit each: value j of a row is bit j mod 32 of the row's
    word j // 32 (1 → +1)."""
    shape, rows, cols = _grid(shape)
    w = words(key, draw, rows, -(-cols // 32), device, row0=row0)
    dev = w.device
    # bytes first, then bits in uint8: no int64 tensor of one element a value
    octets = ((w[..., None] >> torch.arange(0, 32, 8, device=dev)) & 0xFF).to(torch.uint8)
    bits = (octets[..., None] >> torch.arange(8, dtype=torch.uint8, device=dev)) & 1
    bits = bits.reshape(rows, -1)[:, :cols]  # value j: bit j % 32 of word j // 32
    return torch.where(bits != 0, 1.0, -1.0).to(torch.float32).reshape(shape)


def gumbel(key: Key, draw: int, shape: Shape, device, *, row0: int = 0,
           col0: int = 0) -> torch.Tensor:
    """float32 standard Gumbels ``−log(−log u)``, u uniform clamped to
    ``finfo.tiny`` (``col0``: the columns from there, as :func:`words`)."""
    return -torch.log(-torch.log(_tiny(uniform(key, draw, shape, device, row0=row0,
                                               col0=col0))))


def integers(key: Key, draw: int, shape: Shape, n: int, device, *, row0: int = 0) -> torch.Tensor:
    """int64 indices uniform on [0, n): ``(w · n) >> 32`` of one word each
    (n < 2³¹)."""
    shape, rows, cols = _grid(shape)
    return ((words(key, draw, rows, cols, device, row0=row0) * int(n)) >> 32).reshape(shape)


def index(key: Key, draw: int, n: int, device) -> torch.Tensor:
    """One index uniform on [0, n) as a ``[1]`` int64 tensor."""
    return integers(key, draw, 1, n, device)


class Stream:
    """A Philox key and the number of draws taken from it.  Each draw takes
    the next draw number, so sequential draws are independent and a run
    replayed draw by draw lands on the same numbers."""

    def __init__(self, key: Key):
        self.key = (int(key[0]) & MASK32, int(key[1]) & MASK32)
        self.draws = 0

    @classmethod
    def from_generator(cls, gen: torch.Generator) -> "Stream":
        return cls(key_from_generator(gen))

    def take(self) -> int:
        """The next draw number (for a draw made in chunks)."""
        self.draws += 1
        return self.draws - 1

    def normal(self, shape: Shape, device) -> torch.Tensor:
        return normal(self.key, self.take(), shape, device)

    def rademacher(self, shape: Shape, device) -> torch.Tensor:
        return rademacher(self.key, self.take(), shape, device)

    def index(self, n: int, device) -> torch.Tensor:
        return index(self.key, self.take(), n, device)

    def integers(self, shape: Shape, n: int, device) -> torch.Tensor:
        return integers(self.key, self.take(), shape, n, device)

    def words(self, rows: int, cols: int, device) -> torch.Tensor:
        return words(self.key, self.take(), rows, cols, device)

