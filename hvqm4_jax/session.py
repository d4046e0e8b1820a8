"""Decode session: the reference-shaped L2/L3 API over the device pipeline.

Mirrors the GC-SDK API surface the reference exposes (SURVEY.md §2.1:
`HVQM4InitDecoder`, `HVQM4InitSeqObj`, `HVQM4BuffSize`, `HVQM4SetBuffer`,
`HVQM4DecodeIpic/Ppic/Bpic`) in idiomatic form: a `DecoderSession` owning
device-resident state (reference ring + nest in device memory), with per-frame entry
points driven by the host planner. Thin functional shims with the SDK names
are provided at the bottom for API parity.

Pipeline per frame (SURVEY.md §3.2 "rebuild cut"):
  host: payload → Planner → FramePlan (all serial deps resolved)
  device: plan tensors → decode_plane_{intra,inter} → u8 planes (stay on device)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np

from .config import MEDIA_VIDEO, SeqConfig
from .container import Demuxer, Record
from .planner import Planner
from .plans import FramePlan
from .utils.profiling import StageTimer


@dataclasses.dataclass
class DecodedFrame:
    display_id: int
    ftype: str
    planes: list  # [Y, U, V] device (or numpy) u8 arrays

    def to_numpy(self) -> list[np.ndarray]:
        return [np.asarray(p) for p in self.planes]

    def yuv_bytes(self) -> bytes:
        return b"".join(np.asarray(p).tobytes() for p in self.planes)


class DecoderSession:
    """One decode session for one sequence configuration.

    `backend`:
      - "jax": the XLA device core (default; frames live on device)
      - "numpy": the golden CPU model (debug / differential testing)
    """

    def __init__(self, cfg: SeqConfig, backend: str = "jax",
                 planner: Planner | None = None, profile: bool = False):
        self.cfg = cfg
        self.backend = backend
        if planner is None:
            try:  # production entropy path; Python planner as fallback
                from .native import NativePlanner

                planner = NativePlanner(cfg)
            except Exception:
                planner = Planner(cfg)
        self.planner = planner
        self.timer = StageTimer(enabled=profile)
        if backend == "jax":
            import jax.numpy as jnp  # deferred so numpy backend needs no jax

            self._jnp = jnp
            from .ops import device_core

            self._core = device_core
        elif backend != "numpy":
            raise ValueError(f"unknown backend {backend!r}")
        self.reset()

    # -- state -----------------------------------------------------------------

    def reset(self) -> None:
        """Reset reference state — GOP block boundary / seek (FORMAT.md §2)."""
        self.ref_prev = None
        self.ref_last = None
        if self.backend == "jax":
            self.nest = self._jnp.zeros(self.cfg.nest_shape, self._jnp.uint8)
        else:
            self.nest = np.zeros(self.cfg.nest_shape, np.uint8)

    # -- frame decode ----------------------------------------------------------

    def decode_plan(self, plan: FramePlan) -> DecodedFrame:
        with self.timer.stage("device"):
            if self.backend == "jax":
                planes = self._decode_plan_jax(plan)
            else:
                planes = self._decode_plan_numpy(plan)
        if plan.ftype in ("I", "P"):
            self.ref_prev = self.ref_last
            self.ref_last = planes
        return DecodedFrame(plan.display_id, plan.ftype, planes)

    def _decode_plan_jax(self, plan: FramePlan):
        jnp = self._jnp
        core = self._core
        if plan.ftype == "I":
            self.nest = jnp.asarray(plan.nest)
        elif self.ref_last is None:
            raise ValueError("P/B frame without reference")
        elif plan.ftype == "B" and self.ref_prev is None:
            raise ValueError("B frame without two references")
        planes = []
        for pi, p in enumerate(plan.planes):
            arrs = {k: jnp.asarray(v)
                    for k, v in core.plane_plan_arrays(p).items()}
            if plan.ftype == "I":
                planes.append(core.decode_plane_intra(arrs, self.nest))
            else:
                r1 = self.ref_last[pi]
                r0 = self.ref_prev[pi] if plan.ftype == "B" else r1
                planes.append(core.decode_plane_inter(arrs, self.nest, r0, r1))
        return planes

    def _decode_plan_numpy(self, plan: FramePlan):
        from . import refdec

        if plan.ftype == "I":
            self.nest = plan.nest
        elif self.ref_last is None:
            raise ValueError("P/B frame without reference")
        elif plan.ftype == "B" and self.ref_prev is None:
            raise ValueError("B frame without two references")
        planes = []
        for pi, p in enumerate(plan.planes):
            if plan.ftype == "I":
                planes.append(refdec.decode_plane(p, self.nest, None, None))
            else:
                r1 = self.ref_last[pi]
                r0 = self.ref_prev[pi] if plan.ftype == "B" else r1
                planes.append(refdec.decode_plane(p, self.nest, r0, r1))
        return planes

    # -- record / clip level ---------------------------------------------------

    def decode_record(self, rec: Record) -> DecodedFrame:
        if rec.media_type != MEDIA_VIDEO:
            raise ValueError("not a video record")
        with self.timer.stage("plan"):
            plan = self.planner.plan_frame(rec.frame_char, rec.payload)
        return self.decode_plan(plan)

    def decode_clip(self, data: bytes, start_block: int = 0) -> Iterator[DecodedFrame]:
        """Decode a whole `.h4m` file (optionally seeking to a GOP block).

        Frames are yielded in *decode order* (the conformance surface, same
        as the C oracle's output). Use `decode_clip_display_order` for
        presentation order."""
        demux = Demuxer(data)
        if demux.info.cfg != self.cfg:
            raise ValueError("clip parameters do not match session config")
        for b in range(start_block, len(demux.block_offsets)):
            self.reset()  # each block is a seek point
            for rec in demux.block_records(b):
                if rec.media_type == MEDIA_VIDEO:
                    yield self.decode_record(rec)

    def decode_clip_display_order(self, data: bytes,
                                  start_block: int = 0) -> Iterator[DecodedFrame]:
        """Decode and yield frames in *display* order.

        The reference's `main` handles presentation reordering by rotating
        past/present/future buffers (SURVEY.md §3.4); here a small pending map
        holds each anchor until the B-frames displayed before it have decoded
        (bounded by the GOP's B-run length — frames stay on device).
        """
        pending: dict[int, DecodedFrame] = {}
        next_disp: int | None = None
        for frame in self.decode_clip(data, start_block=start_block):
            if next_disp is None:
                next_disp = frame.display_id  # seek: start at first decoded id
            pending[frame.display_id] = frame
            while next_disp in pending:
                yield pending.pop(next_disp)
                next_disp += 1
        for disp in sorted(pending):  # trailing anchors
            yield pending.pop(disp)


# ---------------------------------------------------------------------------
# SDK-shaped functional shims (API parity with SURVEY.md §2.1 symbols).
# ---------------------------------------------------------------------------

def HVQM4InitDecoder() -> None:
    """Global init. The reference builds clip/divide lookup tables here; in the
    device rebuild those are compile-time constants inside the jitted core, so this
    is a no-op kept for API parity."""


def HVQM4InitSeqObj(width: int, height: int, h_samp: int = 2,
                    v_samp: int = 2) -> SeqConfig:
    return SeqConfig(width=width, height=height, h_samp=h_samp, v_samp=v_samp)


def HVQM4BuffSize(seq: SeqConfig) -> int:
    """Workspace bytes the reference would require: 4 frame buffers (3 I/P ring
    + 1 B output) + nest. Informational — JAX manages device memory itself."""
    nh, nw = seq.nest_shape
    return 4 * seq.frame_bytes + nh * nw


def HVQM4SetBuffer(seq: SeqConfig, _workspace=None, **kwargs) -> DecoderSession:
    """Create the decode session (the reference carves caller memory here;
    we allocate device state instead)."""
    return DecoderSession(seq, **kwargs)


def HVQM4DecodeIpic(session: DecoderSession, payload: bytes) -> DecodedFrame:
    plan = session.planner.plan_frame("I", payload)
    return session.decode_plan(plan)


def HVQM4DecodePpic(session: DecoderSession, payload: bytes) -> DecodedFrame:
    plan = session.planner.plan_frame("P", payload)
    return session.decode_plan(plan)


def HVQM4DecodeBpic(session: DecoderSession, payload: bytes) -> DecodedFrame:
    plan = session.planner.plan_frame("B", payload)
    return session.decode_plan(plan)
