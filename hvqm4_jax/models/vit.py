"""ViT video encoder fed directly from the decode pipeline (BASELINE config 5).

The end-to-end path decode→YUV→RGB→resize→ViT runs entirely on device: frames
never visit the host. Pure-JAX implementation (no flax dependency on the hot
path), bfloat16 weights/activations with f32 accumulation so matmuls run on
the accelerator's bf16 matrix units at full rate.

Tensor-parallel ready: attention heads and the MLP hidden dimension are the
natural shard axes; `shard_vit_params` places them over a mesh's 'tp' axis
and XLA's SPMD partitioner inserts the all-reduces after the output
projections (the "annotate shardings, let XLA insert collectives" recipe).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np


# Agreement bound for the same embeddings computed on two devices or
# shardings. Activations are stored in bf16 (8-bit mantissa, 2^-8 relative
# rounding) after every projection of every block, and the two runs sum in
# different orders, so a last-bit flip in one cast propagates through the
# residual stream; a 3% relative L2 error per embedding still separates a
# correct run from a wrong layout or missing collective, which give O(1).
EMBED_RTOL = 0.03


def embedding_error(got, want) -> float:
    """Largest per-row relative L2 error of `got` against `want` (N, dim)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    num = np.linalg.norm(got - want, axis=-1)
    den = np.maximum(np.linalg.norm(want, axis=-1), 1e-12)
    return float(np.max(num / den))


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    dim: int = 384
    depth: int = 6
    heads: int = 6
    mlp_ratio: int = 4

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def init_vit(cfg: ViTConfig, key) -> dict:
    """Initialize parameters (bf16) as a flat-ish pytree."""
    k = iter(jax.random.split(key, 4 + 8 * cfg.depth))
    d, hd, nh = cfg.dim, cfg.head_dim, cfg.heads
    mlp = cfg.mlp_ratio * d
    patch_in = 3 * cfg.patch_size ** 2

    def dense(key, fan_in, shape):
        return (jax.random.normal(key, shape, jnp.float32)
                / math.sqrt(fan_in)).astype(jnp.bfloat16)

    params = {
        "patch_w": dense(next(k), patch_in, (patch_in, d)),
        "patch_b": jnp.zeros((d,), jnp.bfloat16),
        "pos": dense(next(k), d, (cfg.n_patches, d)),
        "ln_f": {"g": jnp.ones((d,), jnp.float32),
                 "b": jnp.zeros((d,), jnp.float32)},
        "blocks": [],
    }
    for _ in range(cfg.depth):
        params["blocks"].append({
            "ln1": {"g": jnp.ones((d,), jnp.float32),
                    "b": jnp.zeros((d,), jnp.float32)},
            "wq": dense(next(k), d, (d, nh, hd)),
            "wk": dense(next(k), d, (d, nh, hd)),
            "wv": dense(next(k), d, (d, nh, hd)),
            "wo": dense(next(k), d, (nh, hd, d)),
            "ln2": {"g": jnp.ones((d,), jnp.float32),
                    "b": jnp.zeros((d,), jnp.float32)},
            "w1": dense(next(k), d, (d, mlp)),
            "b1": jnp.zeros((mlp,), jnp.bfloat16),
            "w2": dense(next(k), mlp, (mlp, d)),
            "b2": jnp.zeros((d,), jnp.bfloat16),
        })
    return params


def _ln(x, p):
    x = x.astype(jnp.float32)
    mu = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    return ((x - mu) * jax.lax.rsqrt(var + 1e-6) * p["g"] + p["b"]).astype(jnp.bfloat16)


def vit_encode(params: dict, cfg: ViTConfig, images: jnp.ndarray) -> jnp.ndarray:
    """(B, H, W, 3) f32 in [0,1] → (B, dim) f32 pooled embeddings."""
    B = images.shape[0]
    ps = cfg.patch_size
    g = cfg.image_size // ps
    x = images.reshape(B, g, ps, g, ps, 3).transpose(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, g * g, ps * ps * 3).astype(jnp.bfloat16)
    x = jnp.einsum("bpi,id->bpd", x, params["patch_w"],
                   preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    x = x + params["patch_b"] + params["pos"]

    scale = 1.0 / math.sqrt(cfg.head_dim)
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1"])
        q = jnp.einsum("bpd,dnh->bpnh", h, blk["wq"],
                       preferred_element_type=jnp.float32)
        kk = jnp.einsum("bpd,dnh->bpnh", h, blk["wk"],
                        preferred_element_type=jnp.float32)
        v = jnp.einsum("bpd,dnh->bpnh", h, blk["wv"],
                       preferred_element_type=jnp.float32)
        # QK^T in bf16 inputs / f32 accumulate, like every other einsum —
        # q/kk come out of their projections as f32
        att = jnp.einsum("bqnh,bknh->bnqk",
                         q.astype(jnp.bfloat16), kk.astype(jnp.bfloat16),
                         preferred_element_type=jnp.float32) * scale
        att = jax.nn.softmax(att, axis=-1).astype(jnp.bfloat16)
        o = jnp.einsum("bnqk,bknh->bqnh", att, v.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        x = x + jnp.einsum("bqnh,nhd->bqd", o, blk["wo"],
                           preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        h = _ln(x, blk["ln2"])
        h = jnp.einsum("bpd,dm->bpm", h, blk["w1"],
                       preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        h = jax.nn.gelu(h + blk["b1"])
        x = x + jnp.einsum("bpm,md->bpd", h, blk["w2"],
                           preferred_element_type=jnp.float32).astype(jnp.bfloat16)

    x = _ln(x, params["ln_f"]).astype(jnp.float32)
    return x.mean(axis=1)


def shard_vit_params(params: dict, mesh, axis: str = "tp") -> dict:
    """Place head/MLP-hidden dimensions over the mesh's tensor axis."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    def put(x, spec):
        return jax.device_put(x, ns(*spec))

    out = dict(params)
    out["patch_w"] = put(params["patch_w"], (None, None))
    out["blocks"] = []
    for blk in params["blocks"]:
        b = dict(blk)
        b["wq"] = put(blk["wq"], (None, axis, None))
        b["wk"] = put(blk["wk"], (None, axis, None))
        b["wv"] = put(blk["wv"], (None, axis, None))
        b["wo"] = put(blk["wo"], (axis, None, None))
        b["w1"] = put(blk["w1"], (None, axis))
        b["b1"] = put(blk["b1"], (axis,))
        b["w2"] = put(blk["w2"], (axis, None))
        out["blocks"].append(b)
    return out
