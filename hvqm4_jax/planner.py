"""Host planner: frame payload bytes → `FramePlan` (reference layers L4/L5).

This is the serial half of the pipeline (SURVEY.md §3.2 "rebuild cut"): the
Huffman walks and the DC/MV prediction chains are inherently sequential, so
they run on the host and everything the device needs is resolved here
into dense tensors:

- basisnum symbols + zero-run expansion  (ref `getDeltaBN`, SURVEY.md §2.2)
- DC deltas + left/up prediction chain   (ref `getDeltaDC`/`dcBlock`)
- MB types incl. skip-map spreading      (ref `spread_PB_descMap`)
- MV deltas + prediction chain, chroma MV derivation
- AOT basis descriptors, raw-block bytes (ref `GetAotBasis`/`OrgBlock` inputs)
- the nest (from the luma DC grid, FORMAT.md §6.1)

A C++ implementation of the same loop lives in `hvqm4_jax/native/` for
throughput; this Python version is the readable reference and the fallback.
Both must produce identical `FramePlan`s (tested in tests/test_native.py).
"""

from __future__ import annotations

import struct

import numpy as np

from .bitio import BitReader, HuffReader
from .config import (
    FRAME_HEADER_SIZE, MAX_BASES, N_STREAMS, SeqConfig,
    STREAM_AUX, STREAM_BASISNUM, STREAM_DC, STREAM_MBTYPE, STREAM_MV,
)
from .plans import FramePlan, PlanePlan, build_nest

CLS_INTRA = 0
CLS_INTER = 1

MB_COPY = 0
MB_INTRA = 1
MB_INTER = 2

REF_PAST = 0
REF_LAST = 1


def _wrap16(v: int) -> int:
    """Wrap to signed 16-bit (the MV prediction-chain width, FORMAT.md §7.2)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def default_planner_factory():
    """The production planner class: native C++ when its module builds on
    this host, else the readable Python Planner (identical plans — the
    suite differential-tests them)."""
    try:
        from .native import NativePlanner
        return NativePlanner
    except Exception:
        return Planner
REF_BI = 2


class PlannerError(ValueError):
    """Malformed frame payload (invalid symbol, truncated stream, ...)."""


class _BasisNumSource:
    """basisnum symbols with run-escape expansion (FORMAT.md §5.3)."""

    def __init__(self, h: HuffReader):
        self.h = h
        self.pending_zeros = 0

    def next(self) -> int:
        if self.pending_zeros:
            self.pending_zeros -= 1
            return 0
        s = self.h.symbol()
        if s == 7:
            n = self.h.raw(8)
            self.pending_zeros = n  # n+1 zeros total; emit one now
            return 0
        if s > 7:
            raise PlannerError(f"basisnum symbol {s} out of range")
        return s


def _delta(h: HuffReader) -> int:
    """Shared DC/MV delta decoding: symbol or 16-bit escape (FORMAT.md §5.4/§7.2)."""
    s = h.symbol()
    if s == 255:
        return h.signed(16)
    return s - 127


class Planner:
    """Stateless per-frame planner for one sequence configuration."""

    def __init__(self, cfg: SeqConfig):
        self.cfg = cfg

    # -- public ---------------------------------------------------------------

    def plan_frame(self, ftype: str, payload: bytes) -> FramePlan:
        try:
            return self._plan(ftype, payload)
        except PlannerError:
            raise
        except (EOFError, IndexError, ValueError, struct.error) as e:
            # ValueError covers bitio-level rejections (e.g. tree too deep)
            raise PlannerError(f"truncated/corrupt frame payload: {e}") from None

    # -- internals ------------------------------------------------------------

    def _plan(self, ftype: str, payload: bytes) -> FramePlan:
        cfg = self.cfg
        if ftype not in ("I", "P", "B"):
            raise PlannerError(f"bad frame type {ftype!r}")
        if len(payload) < FRAME_HEADER_SIZE:
            raise PlannerError("payload shorter than frame header")
        display_id, nest_x, nest_y, dc_shift, n_slices, _r2 = struct.unpack_from(
            ">IHHBBH", payload, 0)
        sizes = struct.unpack_from(f">{N_STREAMS}I", payload, 12)
        if dc_shift > 7:
            raise PlannerError(f"dc_shift {dc_shift} out of range")
        if _r2 != 0:
            raise PlannerError("reserved frame-header field must be zero")
        if sizes[5] != 0:
            raise PlannerError("reserved stream 5 must be empty")
        mh, _mw = cfg.mb_grid
        S = max(n_slices, 1)
        if S > mh:
            raise PlannerError(f"slice count {S} exceeds MB rows {mh}")
        off = FRAME_HEADER_SIZE
        seg_sizes = None
        if n_slices >= 2:  # sliced layout (FORMAT.md §9): 6 x S sub-table
            sub_len = 4 * N_STREAMS * S
            if off + sub_len > len(payload):
                raise PlannerError("truncated slice sub-table")
            seg_sizes = [struct.unpack_from(f">{S}I", payload,
                                            off + 4 * S * k)
                         for k in range(N_STREAMS)]
            off += sub_len
        streams = []
        for k, sz in enumerate(sizes):
            if off + sz > len(payload):
                raise PlannerError("stream overruns payload")
            if seg_sizes is not None and sum(seg_sizes[k]) != sz:
                raise PlannerError("slice segments do not sum to stream size")
            streams.append(payload[off:off + sz])
            off += sz
        if off != len(payload):
            raise PlannerError("trailing bytes after streams")

        def slice_streams(s: int) -> list[bytes]:
            if seg_sizes is None:
                return streams
            out = []
            for k in range(N_STREAMS):
                start = sum(seg_sizes[k][:s])
                out.append(streams[k][start:start + seg_sizes[k][s]])
            return out

        planes = [PlanePlan.zeros(bh, bw) for bh, bw in cfg.block_grids]
        mb_map = np.zeros(cfg.mb_grid, np.uint8)
        mv_map = np.zeros((*cfg.mb_grid, 2), np.int32)
        mv2_map = np.zeros((*cfg.mb_grid, 2), np.int32)
        ref_map = np.zeros(cfg.mb_grid, np.uint8)

        for s in range(S):
            segs = slice_streams(s)
            bn = _BasisNumSource(HuffReader(segs[STREAM_BASISNUM]))
            dch = HuffReader(segs[STREAM_DC])
            aux = BitReader(segs[STREAM_AUX])
            mbt = BitReader(segs[STREAM_MBTYPE])
            mvh = HuffReader(segs[STREAM_MV])
            ms0, ms1 = s * mh // S, (s + 1) * mh // S
            if ftype in ("P", "B"):
                self._mb_rows(ftype, mbt, mvh, mb_map, mv_map, mv2_map,
                              ref_map, ms0, ms1)
            for pi, (bh, bw) in enumerate(cfg.block_grids):
                chroma = pi > 0
                rows_per_mb = 1 if (chroma and cfg.h_samp == 2) else 2
                self._plane_rows(
                    planes[pi], pi, bw, ftype, dc_shift, bn, dch, aux,
                    mb_map, mv_map, mv2_map, ref_map,
                    ms0 * rows_per_mb, ms1 * rows_per_mb)

        nest = None
        if ftype == "I":
            nest = build_nest(cfg, planes[0].dc, nest_x, nest_y)
        return FramePlan(ftype=ftype, display_id=display_id, dc_shift=dc_shift,
                         nest_x=nest_x, nest_y=nest_y, planes=planes, nest=nest)

    def _mb_rows(self, ftype: str, mbt: BitReader, mvh: HuffReader,
                 mb_map, mv_map, mv2_map, ref_map, ms0: int, ms1: int):
        """Read one slice's MB rows (FORMAT.md §7.1/§9); planes inherit.

        The MV prediction chain starts at (0,0) per slice."""
        _mh, mw = self.cfg.mb_grid
        pred = [0, 0]

        def read_mv():
            # the chain value wraps to signed 16-bit after every delta
            # (FORMAT.md §7.2): defined for arbitrarily long hostile chains
            pred[0] = _wrap16(pred[0] + _delta(mvh))
            pred[1] = _wrap16(pred[1] + _delta(mvh))
            return (pred[0], pred[1])

        for my in range(ms0, ms1):
            for mx in range(mw):
                t = mbt.read_bits(2)
                if t == 3:
                    raise PlannerError("mbtype 3 invalid")
                mb_map[my, mx] = t
                if t == MB_COPY:
                    # copy lowers to inter at mv 0 (plans.py); reference is
                    # ref_last for P, ref_prev for B (FORMAT.md §7.1).
                    ref_map[my, mx] = REF_LAST if ftype == "P" else REF_PAST
                elif t == MB_INTER:
                    if ftype == "B":
                        rs = mbt.read_bits(2)
                        if rs == 3:
                            raise PlannerError("refsel 3 invalid")
                        ref_map[my, mx] = rs
                    else:
                        ref_map[my, mx] = REF_LAST
                    mv_map[my, mx] = read_mv()
                    if ftype == "B" and ref_map[my, mx] == REF_BI:
                        mv2_map[my, mx] = read_mv()

    def _plane_rows(self, p, pi, bw, ftype, dc_shift, bn, dch, aux,
                    mb_map, mv_map, mv2_map, ref_map,
                    row0: int, row1: int) -> None:
        """Scan one plane's block rows [row0, row1) of one slice."""
        cfg = self.cfg
        # Block→MB mapping (FORMAT.md §7.3): luma and 4:4:4 chroma halve the
        # block index; 4:2:0 chroma blocks are co-located with MBs 1:1.
        chroma = pi > 0
        shift_idx = 0 if (chroma and cfg.h_samp == 2) else 1
        mv_shift = 1 if (chroma and cfg.h_samp == 2) else 0

        for by in range(row0, row1):
            for bx in range(bw):
                if ftype == "I":
                    cls_ = CLS_INTRA
                else:
                    my, mx = by >> shift_idx, bx >> shift_idx
                    t = mb_map[my, mx]
                    cls_ = CLS_INTRA if t == MB_INTRA else CLS_INTER
                if cls_ == CLS_INTRA:
                    self._intra_block(p, by, bx, dc_shift, bn, dch, aux, row0)
                else:
                    # only reachable for P/B: my/mx/t from the lookup above
                    p.cls[by, bx] = CLS_INTER
                    p.refsel[by, bx] = ref_map[my, mx]
                    if t == MB_INTER:
                        p.mv[by, bx, 0] = mv_map[my, mx, 0] >> mv_shift
                        p.mv[by, bx, 1] = mv_map[my, mx, 1] >> mv_shift
                        if ref_map[my, mx] == REF_BI:
                            p.mv2[by, bx, 0] = mv2_map[my, mx, 0] >> mv_shift
                            p.mv2[by, bx, 1] = mv2_map[my, mx, 1] >> mv_shift
                        k = bn.next()
                        if k > MAX_BASES:
                            raise PlannerError(f"inter residual count {k} invalid")
                        p.mode[by, bx] = k
                        for b in range(k):
                            self._basis(p, by, bx, b, aux)
                    # copy MB: mode 0, mv 0 — nothing consumed.

    def _intra_block(self, p: PlanePlan, by, bx, dc_shift, bn, dch, aux,
                     row0: int) -> None:
        s = bn.next()
        if s == 5 or s == 7:
            raise PlannerError(f"intra basisnum {s} invalid")
        p.cls[by, bx] = CLS_INTRA
        p.mode[by, bx] = s
        if s == 6:  # raw block; effective DC stays 128 (FORMAT.md §6.6)
            for i in range(16):
                p.raw[by, bx, i] = aux.read_bits(8)
            return
        # DC prediction chain (FORMAT.md §5.4/§9): left, else up-within-slice,
        # else 128.
        if bx > 0:
            pred = int(p.dc[by, bx - 1])
        elif by > row0:
            pred = int(p.dc[by - 1, bx])
        else:
            pred = 128
        v = _delta(dch)
        p.dc[by, bx] = (pred + (v << dc_shift)) & 0xFF
        for b in range(s):
            self._basis(p, by, bx, b, aux)

    @staticmethod
    def _basis(p: PlanePlan, by, bx, b, aux: BitReader) -> None:
        """32-bit AOT basis descriptor (FORMAT.md §6.5)."""
        v = aux.read_bits(32)
        p.basis_nx[by, bx, b] = (v >> 25) & 0x7F
        p.basis_ny[by, bx, b] = (v >> 18) & 0x7F
        p.basis_sx[by, bx, b] = ((v >> 17) & 1) + 1
        p.basis_sy[by, bx, b] = ((v >> 16) & 1) + 1
        p.basis_off[by, bx, b] = (v >> 8) & 0xFF
        scale = v & 0xFF
        p.basis_scale[by, bx, b] = scale - 256 if scale >= 128 else scale
