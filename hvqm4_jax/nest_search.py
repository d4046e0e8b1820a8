"""Device nest search for the encoder: every candidate scored as a matmul.

The decoder samples basis vectors from the nest; the encoder's hard problem
is the inverse — for every 4×4 block, find the best nest position/stride.
Exhaustively that is (nest_h·nest_w·4) ≈ 10.6k candidate vectors against
tens of thousands of residuals: a (blocks × 16) @ (16 × candidates) matrix
product. The CPU encoder samples a few hundred candidates; this module
scores ALL of them on device, tiled over candidates so peak memory stays at
`blocks × TILE` f32.

The product runs in float32 at HIGHEST precision: its operands are integers
of magnitude ≤ 255 and K = 16, so every dot product (≤ 16·255² < 2^24) is
exact in float32 — but not in the TF32 a GPU would otherwise use, which
keeps 10 mantissa bits. Exact dots make the chosen candidate the same on
every device except where two candidates tie exactly in gain. The caller
re-evaluates the winners with exact integer semantics before committing,
so encoded streams remain spec-exact (the decode side never sees floats).

Usage (see `encode.VideoEncoder(use_device_search=True)`):
    search = NestSearch(nest)                   # per I-frame / GOP
    descs, terms, scales = search.best(resids)  # (B,16) -> (B,5),(B,16),(B,)
    # descs = (nx, ny, sxb, syb, off) rows; terms = UNSHIFTED (sample-off)*
    # scale per pixel — callers sum terms across bases and apply the
    # decoder's single >>4 (FORMAT.md §6.2)
"""

from __future__ import annotations

import numpy as np

TILE = 1024


def _all_candidates(nest: np.ndarray):
    """Every (nx, ny, sxb, syb) candidate: descriptors + centered vectors."""
    nh, nw = nest.shape
    i = np.arange(4)
    descs = []
    vecs = []
    for syb in (0, 1):
        for sxb in (0, 1):
            rows = (np.arange(nh)[:, None] + i[None, :] * (syb + 1)) % nh
            cols = (np.arange(nw)[:, None] + i[None, :] * (sxb + 1)) % nw
            # v[y, x, i, j] = nest[rows[y,i], cols[x,j]]
            v = nest[rows[:, None, :, None], cols[None, :, None, :]]
            v = v.reshape(nh * nw, 16).astype(np.int32)
            ny, nx = np.divmod(np.arange(nh * nw), nw)
            off = np.clip(np.round(v.mean(1)), 0, 255).astype(np.int32)
            descs.append(np.stack([nx, ny,
                                   np.full(nh * nw, sxb),
                                   np.full(nh * nw, syb), off], 1))
            vecs.append(v - off[:, None])
    desc = np.concatenate(descs)          # (K, 5): nx, ny, sxb, syb, off
    C = np.concatenate(vecs)              # (K, 16) centered int32
    keep = (C != 0).any(1)                # drop flat candidates
    return desc[keep], C[keep]


class NestSearch:
    """Full-nest matching-pursuit step, batched over blocks on device."""

    def __init__(self, nest: np.ndarray):
        import jax
        import jax.numpy as jnp

        self.desc, C = _all_candidates(nest)
        self.C = C
        self.ok = len(C) > 0
        if not self.ok:
            return
        k = len(C)
        pad = -(-k // TILE) * TILE
        Cf = np.zeros((pad, 16), np.float32)
        Cf[:k] = C.astype(np.float32)
        cc = (Cf * Cf).sum(1)
        cc[k:] = 1.0  # padded rows never win (dot = 0)
        Cd = jnp.asarray(Cf)
        ccd = jnp.asarray(cc)
        n_tiles = pad // TILE

        @jax.jit
        def search(R):  # (B, 16) f32 -> best idx (B,), dot (B,), cc (B,)
            def tile(carry, t):
                best_gain, best_idx, best_dot, best_cc = carry
                Ct = jax.lax.dynamic_slice(Cd, (t * TILE, 0), (TILE, 16))
                cct = jax.lax.dynamic_slice(ccd, (t * TILE,), (TILE,))
                dots = jnp.matmul(R, Ct.T,         # (B, TILE), exact
                                  precision=jax.lax.Precision.HIGHEST)
                gains = dots * dots / cct[None, :]
                am = jnp.argmax(gains, axis=1)
                g = jnp.take_along_axis(gains, am[:, None], 1)[:, 0]
                d = jnp.take_along_axis(dots, am[:, None], 1)[:, 0]
                c = cct[am]
                upd = g > best_gain
                return ((jnp.where(upd, g, best_gain),
                         jnp.where(upd, am + t * TILE, best_idx),
                         jnp.where(upd, d, best_dot),
                         jnp.where(upd, c, best_cc)), None)

            B = R.shape[0]
            init = (jnp.full(B, -1.0), jnp.zeros(B, jnp.int32),
                    jnp.zeros(B), jnp.ones(B))
            (g, idx, d, c), _ = jax.lax.scan(tile, init,
                                             jnp.arange(n_tiles))
            return idx, d, c

        self._search = search

    def best(self, residuals: np.ndarray):
        """(B, 16) residuals → (desc rows (B,5), UNSHIFTED integer terms
        (B,16) = (sample − off)·scale, scales (B,)).

        The decoder sums terms across a block's bases and arithmetic-shifts
        the SUM once (`(Σ terms) >> 4`, FORMAT.md §6.2) — returning
        unshifted terms lets callers reproduce that exactly (per-term
        shifting loses up to 1 LSB/pixel per extra basis)."""
        import jax.numpy as jnp

        idx, dot, cc = self._search(jnp.asarray(residuals, jnp.float32))
        idx = np.asarray(idx)
        scale = np.clip(np.round(16.0 * np.asarray(dot) / np.asarray(cc)),
                        -128, 127).astype(np.int32)
        C = self.C[idx]                              # (B, 16) int32
        return self.desc[idx], C * scale[:, None], scale
