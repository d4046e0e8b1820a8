"""Unit tests for the host entropy primitives (SURVEY.md §4.4)."""

import numpy as np
import pytest

from hvqm4_jax.bitio import (
    BitReader, BitWriter, HuffReader, HuffWriter, build_tree, code_table,
    decode_symbol, read_tree, write_tree,
)


def test_bit_roundtrip():
    rng = np.random.default_rng(0)
    fields = [(int(rng.integers(0, 1 << n)), n)
              for n in rng.integers(1, 25, size=200)]
    w = BitWriter()
    for v, n in fields:
        w.write_bits(v, n)
    r = BitReader(w.getvalue())
    for v, n in fields:
        assert r.read_bits(n) == v


def test_signed_roundtrip():
    w = BitWriter()
    vals = [-32768, -1, 0, 1, 32767, -127, 128]
    for v in vals:
        w.write_signed(v, 16)
    r = BitReader(w.getvalue())
    for v in vals:
        assert r.read_signed(16) == v


def test_reader_eof():
    r = BitReader(b"\xff")
    r.read_bits(8)
    with pytest.raises(EOFError):
        r.read_bit()


def test_tree_roundtrip():
    rng = np.random.default_rng(1)
    syms = rng.integers(0, 256, size=500).tolist()
    tree = build_tree(syms)
    w = BitWriter()
    write_tree(w, tree)
    r = BitReader(w.getvalue())
    assert read_tree(r) == tree


def test_degenerate_tree_zero_bits():
    """Single-symbol tree: symbols consume no bits (FORMAT.md §4.2)."""
    tree = build_tree([42, 42, 42])
    assert tree == 42
    w = BitWriter()
    write_tree(w, tree)
    r = BitReader(w.getvalue())
    t = read_tree(r)
    pos = r.pos
    for _ in range(10):
        assert decode_symbol(r, t) == 42
    assert r.pos == pos


def test_huffman_prefix_property():
    rng = np.random.default_rng(2)
    syms = rng.choice(256, size=1000, p=np.random.default_rng(3).dirichlet(
        np.full(256, 0.05))).tolist()
    table = code_table(build_tree(syms))
    codes = sorted((f"{bits:0{n}b}" for bits, n in table.values()))
    for a, b in zip(codes, codes[1:]):
        assert not b.startswith(a)


def test_huff_stream_roundtrip_with_raw():
    rng = np.random.default_rng(4)
    hw = HuffWriter()
    script = []
    for _ in range(300):
        if rng.random() < 0.2:
            v, n = int(rng.integers(0, 256)), 8
            hw.put_raw(v, n)
            script.append(("raw", v, n))
        else:
            s = int(rng.integers(0, 12))
            hw.put_symbol(s)
            script.append(("sym", s, 0))
    hr = HuffReader(hw.encode())
    for kind, v, n in script:
        if kind == "sym":
            assert hr.symbol() == v
        else:
            assert hr.raw(n) == v


def test_empty_stream():
    assert HuffWriter().encode() == b""
    hr = HuffReader(b"")
    with pytest.raises(EOFError):
        hr.symbol()
