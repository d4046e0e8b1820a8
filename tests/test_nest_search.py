"""Full-nest encoder search on the device (nest_search.NestSearch)."""

import numpy as np

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.encode import VideoEncoder, _CandidateSet
from hvqm4_jax.nest_search import NestSearch

from .conftest import golden_decode, run_oracle
from .test_encode import _synthetic_video


def test_full_search_at_least_as_good_as_sampled():
    rng = np.random.default_rng(0)
    nest = rng.integers(0, 256, (38, 70), dtype=np.uint8)
    search = NestSearch(nest)
    sampled = _CandidateSet(nest, np.random.default_rng(1))
    residuals = rng.integers(-120, 120, (64, 16)).astype(np.int32)
    _desc, terms, _scales = search.best(residuals)
    # terms are unshifted; the decoder applies >> 4 to the (single-basis) sum
    full_sse = ((residuals - (terms >> 4)) ** 2).sum(1)
    for i in range(len(residuals)):
        hit = sampled.best(residuals[i])
        assert hit is not None
        _b, term = hit
        samp_sse = int(((residuals[i] - (term >> 4)) ** 2).sum())
        # full search scores every candidate; float scoring ties resolve to
        # within one quantization step of the sampled pick
        assert full_sse[i] <= samp_sse + 16, (i, full_sse[i], samp_sse)


def test_full_search_terms_are_exact_decoder_integers():
    rng = np.random.default_rng(2)
    nest = rng.integers(0, 256, (38, 70), dtype=np.uint8)
    search = NestSearch(nest)
    residuals = rng.integers(-100, 100, (8, 16)).astype(np.int32)
    desc, terms, scales = search.best(residuals)
    nh, nw = nest.shape
    for i in range(len(residuals)):
        nx, ny, sxb, syb, off = (int(v) for v in desc[i])
        rows = (ny + np.arange(4) * (syb + 1)) % nh
        cols = (nx + np.arange(4) * (sxb + 1)) % nw
        v = nest[np.ix_(rows, cols)].astype(np.int32).reshape(16)
        # unshifted (sample - off) * scale: the decoder shifts the SUM over
        # a block's bases once (FORMAT.md §6.2)
        want = (v - off) * int(scales[i])
        assert np.array_equal(terms[i], want)


def test_encode_with_device_search_roundtrips(oracle_bin, tmp_path):
    cfg = SeqConfig(64, 48)
    frames = _synthetic_video(cfg, 3, seed=5)
    clip = VideoEncoder(cfg, lambda_bits=2.0,
                        use_device_search=True).encode(frames, ["IPP"])
    oracle_yuv = run_oracle(oracle_bin, clip, tmp_path)
    got = b"".join(f.tobytes() for f in golden_decode(cfg, clip))
    assert got == oracle_yuv
