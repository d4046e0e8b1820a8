"""Bit-level I/O and Huffman coding for HVQM4 substreams.

Host-side entropy primitives (SURVEY.md §2.2: `getBit`/`setCode` bit reader,
`readTree` serialized-tree reader, `decodeHuff` tree walker). Bit order is
MSB-first per docs/FORMAT.md §4. The writer half has no counterpart in the
reference decoder — it exists for `tools/encoder.py` (the synthetic-corpus
generator mandated by SURVEY.md §4.2).

This pure-Python implementation is the readable one; `hvqm4_jax/native/` holds
the C++ hot path used by the production planner.
"""

from __future__ import annotations

import heapq
from collections import Counter


class BitReader:
    """MSB-first bit reader over a bytes-like payload."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.nbits = 8 * len(data)

    def read_bit(self) -> int:
        p = self.pos
        if p >= self.nbits:
            raise EOFError("bit stream exhausted")
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def read_signed(self, n: int) -> int:
        v = self.read_bits(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v


class BitWriter:
    """MSB-first bit writer; zero-pads the final byte."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cur = 0
        self._fill = 0

    def write_bit(self, b: int) -> None:
        self._cur = (self._cur << 1) | (b & 1)
        self._fill += 1
        if self._fill == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._fill = 0

    def write_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write_bit((v >> i) & 1)

    def write_signed(self, v: int, n: int) -> None:
        self.write_bits(v & ((1 << n) - 1), n)

    def getvalue(self) -> bytes:
        out = bytearray(self._bytes)
        if self._fill:
            out.append(self._cur << (8 - self._fill))
        return bytes(out)

    def bit_length(self) -> int:
        return 8 * len(self._bytes) + self._fill


# ---------------------------------------------------------------------------
# Huffman trees.  A tree is nested tuples: leaf = int symbol; internal =
# (child0, child1).  Serialization per FORMAT.md §4.2.
# ---------------------------------------------------------------------------

Tree = "int | tuple"  # documentation alias


def read_tree(r: BitReader, depth: int = 0, _internal=None):
    """`readTree` equivalent: 1 = internal (child0 then child1), 0 = leaf + 8b.

    Normative caps (FORMAT.md §4.2): depth ≤ 64, ≤ 1024 internal nodes."""
    if _internal is None:
        _internal = [0]
    if depth > 64:
        raise ValueError("Huffman tree too deep (corrupt stream)")
    if r.read_bit():
        _internal[0] += 1
        if _internal[0] > 1024:
            raise ValueError("Huffman tree too large (corrupt stream)")
        c0 = read_tree(r, depth + 1, _internal)
        c1 = read_tree(r, depth + 1, _internal)
        return (c0, c1)
    return r.read_bits(8)


def write_tree(w: BitWriter, tree) -> None:
    if isinstance(tree, tuple):
        w.write_bit(1)
        write_tree(w, tree[0])
        write_tree(w, tree[1])
    else:
        w.write_bit(0)
        w.write_bits(tree, 8)


def decode_symbol(r: BitReader, tree) -> int:
    """`decodeHuff` equivalent. Degenerate single-leaf tree consumes 0 bits."""
    node = tree
    while isinstance(node, tuple):
        node = node[r.read_bit()]
    return node


def build_tree(symbols) -> "tuple | int | None":
    """Build a Huffman tree from an iterable of emitted symbols.

    Returns None for an empty sequence; a bare leaf for a single distinct
    symbol (degenerate tree, FORMAT.md §4.2). Ties broken deterministically
    so encoder output is reproducible.
    """
    counts = Counter(symbols)
    if not counts:
        return None
    if len(counts) == 1:
        return next(iter(counts))
    heap = [(n, sym, sym) for sym, n in sorted(counts.items())]
    heapq.heapify(heap)
    while len(heap) > 1:
        n0, t0, tree0 = heapq.heappop(heap)
        n1, t1, tree1 = heapq.heappop(heap)
        heapq.heappush(heap, (n0 + n1, min(t0, t1), (tree0, tree1)))
    return heap[0][2]


def code_table(tree) -> dict[int, tuple[int, int]]:
    """symbol -> (bits, nbits). Degenerate tree: 0-bit code."""
    table: dict[int, tuple[int, int]] = {}

    def walk(node, bits: int, n: int) -> None:
        if isinstance(node, tuple):
            walk(node[0], bits << 1, n + 1)
            walk(node[1], (bits << 1) | 1, n + 1)
        else:
            table[node] = (bits, n)

    if tree is not None:
        walk(tree, 0, 0)
    return table


class HuffWriter:
    """Two-pass helper: collect symbols, then serialize tree + codes."""

    def __init__(self) -> None:
        self.symbols: list[tuple[str, int, int]] = []  # (kind, value, nbits)

    def put_symbol(self, s: int) -> None:
        self.symbols.append(("sym", s, 0))

    def put_raw(self, v: int, n: int) -> None:
        """Raw bits interleaved into the same stream (escapes, run lengths)."""
        self.symbols.append(("raw", v, n))

    def encode(self) -> bytes:
        syms = [v for k, v, _ in self.symbols if k == "sym"]
        if not syms:
            if self.symbols:
                raise ValueError("raw bits in a Huffman stream with no symbols")
            return b""
        tree = build_tree(syms)
        table = code_table(tree)
        w = BitWriter()
        write_tree(w, tree)
        for kind, v, n in self.symbols:
            if kind == "sym":
                bits, nb = table[v]
                w.write_bits(bits, nb)
            else:
                w.write_bits(v & ((1 << n) - 1), n)
        return w.getvalue()


class HuffReader:
    """Tree + symbol reader over one substream."""

    def __init__(self, data: bytes):
        self.r = BitReader(data)
        self.tree = read_tree(self.r) if data else None

    def symbol(self) -> int:
        if self.tree is None:
            raise EOFError("reading symbol from empty stream")
        return decode_symbol(self.r, self.tree)

    def raw(self, n: int) -> int:
        return self.r.read_bits(n)

    def signed(self, n: int) -> int:
        return self.r.read_signed(n)
