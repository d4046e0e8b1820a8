/* hvqm4_oracle.c — reference HVQM4 decoder in C99 (the repo's executable spec).
 *
 * The upstream reference mount was empty (SURVEY.md §0), so this oracle is an
 * independent implementation of docs/FORMAT.md and plays the role that
 * BASELINE.json assigns to "the C reference on CPU": ground truth for
 * bit-exactness, and the fps denominator of the device pipeline's speed-up
 * (single-threaded, -O2, one frame at a time — the reference's execution
 * model per SURVEY.md §1).
 *
 * Deliberately independent of the Python/JAX implementation: per-block scalar
 * code, its own bit reader / Huffman walker / buffer rotation. Shares nothing
 * but the spec.
 *
 * Usage:
 *   hvqm4_oracle [--hash] [--csum] [--bench N] [--audio out.pcm] in.h4m [out.yuv]
 *     --hash      print per-frame FNV-1a hashes of decoded YUV
 *     --csum      print per-frame position-weighted checksums (the reduction
 *                 the device pipeline computes on device; see wsum32 below)
 *     --bench N   decode the file N times, print video fps
 *     --audio F   write decoded IMA-ADPCM audio as s16le interleaved PCM
 *
 * Builds clean under -fsanitize=address,undefined (make asan); all stream
 * reads are bounds-checked and malformed inputs exit(1) (FORMAT.md §9).
 */

#define _POSIX_C_SOURCE 199309L /* clock_gettime for --bench */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

static void die(const char *msg) {
    fprintf(stderr, "hvqm4_oracle: error: %s\n", msg);
    exit(1);
}

/* ---------------- big-endian scalar readers ---------------- */

static uint32_t be32(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | p[3];
}
static uint16_t be16(const uint8_t *p) { return (uint16_t)((p[0] << 8) | p[1]); }

/* ---------------- bit reader (MSB-first, FORMAT.md §4.1) ---------------- */

typedef struct {
    const uint8_t *d;
    size_t nbits, pos;
} BR;

static void br_init(BR *b, const uint8_t *d, size_t n) {
    b->d = d;
    b->nbits = 8 * n;
    b->pos = 0;
}
static unsigned br_bit(BR *b) {
    if (b->pos >= b->nbits) die("bit stream exhausted");
    unsigned v = (b->d[b->pos >> 3] >> (7 - (b->pos & 7))) & 1;
    b->pos++;
    return v;
}
static uint32_t br_bits(BR *b, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | br_bit(b);
    return v;
}
static int32_t br_signed(BR *b, int n) {
    uint32_t v = br_bits(b, n);
    if (v >= (1u << (n - 1))) return (int32_t)v - (1 << n);
    return (int32_t)v;
}

/* ---------------- Huffman (FORMAT.md §4.2) ---------------- */

#define MAX_NODES 1024
typedef struct {
    int16_t child[MAX_NODES][2]; /* -1-sym for leaves encoded as -(sym+1) */
    int n_nodes;
    int root; /* node index, or -(sym+1) for a degenerate single-leaf tree */
    BR br;
    int present;
} Huff;

static int huff_read_tree(Huff *h, int depth) {
    if (depth > 64) die("huffman tree too deep");
    if (br_bit(&h->br)) {
        if (h->n_nodes >= MAX_NODES) die("huffman tree too large");
        int idx = h->n_nodes++;
        int c0 = huff_read_tree(h, depth + 1);
        int c1 = huff_read_tree(h, depth + 1);
        h->child[idx][0] = (int16_t)c0;
        h->child[idx][1] = (int16_t)c1;
        return idx;
    }
    int sym = (int)br_bits(&h->br, 8);
    return -(sym + 1);
}

static void huff_init(Huff *h, const uint8_t *d, size_t n) {
    h->n_nodes = 0;
    h->present = (n > 0);
    br_init(&h->br, d, n);
    h->root = h->present ? huff_read_tree(h, 0) : 0;
}

static int huff_symbol(Huff *h) {
    if (!h->present) die("symbol read from empty huffman stream");
    int node = h->root;
    while (node >= 0) node = h->child[node][br_bit(&h->br)];
    return -node - 1;
}

/* DC/MV delta: symbol or 16-bit escape (FORMAT.md §5.4, §7.2) */
static int32_t huff_delta(Huff *h) {
    int s = huff_symbol(h);
    if (s == 255) return br_signed(&h->br, 16);
    return s - 127;
}

/* ---------------- per-block plan (entropy pass output) ---------------- */

#define CLS_INTRA 0
#define CLS_INTER 1

typedef struct {
    uint8_t cls, mode, refsel, nb;
    uint8_t dc;
    int16_t mvx, mvy, mv2x, mv2y;
    uint8_t bnx[4], bny[4], bsx[4], bsy[4];
    int16_t boff[4], bscale[4];
    uint8_t raw[16];
} Blk;

typedef struct {
    int width, height, h_samp, v_samp;
    int pw[3], ph[3], bw[3], bh[3]; /* plane and block-grid dims */
    int mh, mw;                     /* macroblock grid (luma 8x8) */
    int nest_h, nest_w;
    Blk *blk[3];
    uint8_t *nest;
    /* frame pixel buffers: 3 rotating for I/P + 1 for B output */
    uint8_t *buf[4];
    uint8_t *ref_prev, *ref_last;
    int free_buf; /* next rotating buffer index 0..2 for I/P */
} Dec;

typedef struct {
    uint8_t mbtype, refsel;
    int16_t mvx, mvy, mv2x, mv2y;
} MB;

#define MB_COPY 0
#define MB_INTRA 1
#define MB_INTER 2

static size_t frame_bytes(const Dec *s) {
    return (size_t)s->pw[0] * s->ph[0] + 2u * s->pw[1] * s->ph[1];
}
static uint8_t *plane_ptr(const Dec *s, uint8_t *frame, int pi) {
    size_t off = 0;
    for (int i = 0; i < pi; i++) off += (size_t)s->pw[i] * s->ph[i];
    return frame + off;
}

static void dec_init(Dec *s, int w, int h, int hs, int vs) {
    memset(s, 0, sizeof *s);
    s->width = w;
    s->height = h;
    s->h_samp = hs;
    s->v_samp = vs;
    for (int p = 0; p < 3; p++) {
        s->pw[p] = p ? w / hs : w;
        s->ph[p] = p ? h / vs : h;
        s->bw[p] = s->pw[p] / 4;
        s->bh[p] = s->ph[p] / 4;
        s->blk[p] = calloc((size_t)s->bw[p] * s->bh[p], sizeof(Blk));
        if (!s->blk[p]) die("oom");
    }
    s->mh = h / 8;
    s->mw = w / 8;
    s->nest_h = (w >= h) ? 38 : 70;
    s->nest_w = (w >= h) ? 70 : 38;
    s->nest = calloc((size_t)s->nest_h * s->nest_w, 1);
    if (!s->nest) die("oom");
    for (int i = 0; i < 4; i++) {
        s->buf[i] = calloc(frame_bytes(s), 1);
        if (!s->buf[i]) die("oom");
    }
    s->ref_prev = s->ref_last = NULL;
    s->free_buf = 0;
}

static void dec_free(Dec *s) {
    for (int p = 0; p < 3; p++) free(s->blk[p]);
    for (int i = 0; i < 4; i++) free(s->buf[i]);
    free(s->nest);
}

/* reset reference state at a GOP/block seek point (FORMAT.md §2) */
static void dec_reset_refs(Dec *s) {
    s->ref_prev = s->ref_last = NULL;
    memset(s->nest, 0, (size_t)s->nest_h * s->nest_w);
}

/* ---------------- entropy pass (reference L4/L5) ---------------- */

typedef struct {
    Huff bn, dc, mv;
    BR aux, mbt;
    int bn_zero_run;
} Streams;

static int basisnum_next(Streams *st) {
    if (st->bn_zero_run) {
        st->bn_zero_run--;
        return 0;
    }
    int sym = huff_symbol(&st->bn);
    if (sym == 7) {
        st->bn_zero_run = (int)br_bits(&st->bn.br, 8); /* n+1 zeros, emit one */
        return 0;
    }
    if (sym > 7) die("basisnum symbol out of range");
    return sym;
}

static void read_basis(Blk *b, int i, BR *aux) {
    uint32_t v = br_bits(aux, 32);
    b->bnx[i] = (v >> 25) & 0x7F;
    b->bny[i] = (v >> 18) & 0x7F;
    b->bsx[i] = (uint8_t)(((v >> 17) & 1) + 1);
    b->bsy[i] = (uint8_t)(((v >> 16) & 1) + 1);
    b->boff[i] = (int16_t)((v >> 8) & 0xFF);
    int sc = (int)(v & 0xFF);
    b->bscale[i] = (int16_t)(sc >= 128 ? sc - 256 : sc);
}

/* One slice's block rows [row0, row1) of one plane (FORMAT.md §5/§9;
 * row0 = 0, row1 = bh for unsliced frames). */
static void entropy_plane(Dec *s, int pi, char ftype, int dc_shift,
                          Streams *st, const MB *mbs, int row0, int row1) {
    int bw = s->bw[pi];
    Blk *blks = s->blk[pi];
    int chroma_mb = (pi > 0 && s->h_samp == 2); /* 4:2:0 chroma: block==MB */
    int mv_shift = chroma_mb ? 1 : 0;
    for (int by = row0; by < row1; by++) {
        for (int bx = 0; bx < bw; bx++) {
            Blk *b = &blks[by * bw + bx];
            memset(b, 0, sizeof *b);
            b->dc = 128;
            int is_intra = 1;
            const MB *mb = NULL;
            if (ftype != 'I') {
                int my = chroma_mb ? by : (by >> 1);
                int mx = chroma_mb ? bx : (bx >> 1);
                mb = &mbs[my * s->mw + mx];
                is_intra = (mb->mbtype == MB_INTRA);
            }
            if (is_intra) {
                int mode = basisnum_next(st);
                if (mode == 5) die("intra basisnum 5 invalid");
                b->cls = CLS_INTRA;
                b->mode = (uint8_t)mode;
                if (mode == 6) {
                    for (int i = 0; i < 16; i++)
                        b->raw[i] = (uint8_t)br_bits(&st->aux, 8);
                } else {
                    int pred; /* up-neighbor only within the slice (§9) */
                    if (bx > 0)
                        pred = blks[by * bw + bx - 1].dc;
                    else if (by > row0)
                        pred = blks[(by - 1) * bw + bx].dc;
                    else
                        pred = 128;
                    int32_t v = huff_delta(&st->dc);
                    b->dc = (uint8_t)((uint32_t)(pred + v * (1 << dc_shift)) & 0xFF);
                    b->nb = (uint8_t)mode;
                    for (int i = 0; i < mode; i++) read_basis(b, i, &st->aux);
                }
            } else {
                b->cls = CLS_INTER;
                b->refsel = mb->refsel;
                if (mb->mbtype == MB_INTER) {
                    b->mvx = (int16_t)(mb->mvx >> mv_shift);
                    b->mvy = (int16_t)(mb->mvy >> mv_shift);
                    b->mv2x = (int16_t)(mb->mv2x >> mv_shift);
                    b->mv2y = (int16_t)(mb->mv2y >> mv_shift);
                    int k = basisnum_next(st);
                    if (k > 4) die("inter residual count invalid");
                    b->mode = b->nb = (uint8_t)k;
                    for (int i = 0; i < k; i++) read_basis(b, i, &st->aux);
                } /* copy MB: mv 0, no residual */
            }
        }
    }
}

/* ---------------- pixel synthesis (reference L6/L7) ---------------- */

static int clip_u8(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

/* WeightImBlock equivalent (FORMAT.md §6.3) */
static void weight_block(uint8_t *dst, int stride, int dc, int dcU, int dcD,
                         int dcL, int dcR) {
    static const int w[4] = {4, 1, 0, 0};
    for (int i = 0; i < 4; i++) {
        for (int j = 0; j < 4; j++) {
            int acc = (dcU - dc) * w[i] + (dcD - dc) * w[3 - i] +
                      (dcL - dc) * w[j] + (dcR - dc) * w[3 - j];
            dst[i * stride + j] = (uint8_t)clip_u8(dc + ((acc + 8) >> 4));
        }
    }
}

/* AOT accumulator (FORMAT.md §6.2) into acc[16] */
static void aot_acc(const Dec *s, const Blk *b, int32_t acc[16]) {
    memset(acc, 0, 16 * sizeof(int32_t));
    for (int k = 0; k < b->nb; k++) {
        int scale = b->bscale[k], off = b->boff[k];
        for (int i = 0; i < 4; i++) {
            int ry = (b->bny[k] + i * b->bsy[k]) % s->nest_h;
            for (int j = 0; j < 4; j++) {
                int rx = (b->bnx[k] + j * b->bsx[k]) % s->nest_w;
                acc[i * 4 + j] += (s->nest[ry * s->nest_w + rx] - off) * scale;
            }
        }
    }
}

/* half-pel MC (FORMAT.md §7.4), clamped addressing */
static int mc_sample(const uint8_t *ref, int pw, int ph, int sx, int sy) {
    int ix = sx >> 1, iy = sy >> 1, hx = sx & 1, hy = sy & 1;
#define AT(y, x)                                                      \
    ref[(((y) < 0 ? 0 : ((y) >= ph ? ph - 1 : (y))) * pw) +          \
        ((x) < 0 ? 0 : ((x) >= pw ? pw - 1 : (x)))]
    int a = AT(iy, ix);
    if (!hx && !hy) return a;
    int b = AT(iy, ix + 1);
    if (hx && !hy) return (a + b + 1) >> 1;
    int c = AT(iy + 1, ix);
    if (!hx && hy) return (a + c + 1) >> 1;
    int d = AT(iy + 1, ix + 1);
    return (a + b + c + d + 2) >> 2;
#undef AT
}

static void synth_plane(Dec *s, int pi, uint8_t *dst,
                        const uint8_t *ref0, const uint8_t *ref1) {
    int bw = s->bw[pi], bh = s->bh[pi], pw = s->pw[pi], ph = s->ph[pi];
    Blk *blks = s->blk[pi];
    int32_t acc[16];
    for (int by = 0; by < bh; by++) {
        for (int bx = 0; bx < bw; bx++) {
            Blk *b = &blks[by * bw + bx];
            uint8_t *out = dst + (by * 4) * pw + bx * 4;
            if (b->cls == CLS_INTRA) {
                if (b->mode == 0) {
                    int dc = b->dc;
                    int dcU = by > 0 ? blks[(by - 1) * bw + bx].dc : dc;
                    int dcD = by < bh - 1 ? blks[(by + 1) * bw + bx].dc : dc;
                    int dcL = bx > 0 ? blks[by * bw + bx - 1].dc : dc;
                    int dcR = bx < bw - 1 ? blks[by * bw + bx + 1].dc : dc;
                    weight_block(out, pw, dc, dcU, dcD, dcL, dcR);
                } else if (b->mode == 6) { /* OrgBlock */
                    for (int i = 0; i < 4; i++)
                        for (int j = 0; j < 4; j++)
                            out[i * pw + j] = b->raw[i * 4 + j];
                } else { /* IntraAotBlock */
                    aot_acc(s, b, acc);
                    for (int i = 0; i < 4; i++)
                        for (int j = 0; j < 4; j++)
                            out[i * pw + j] = (uint8_t)clip_u8(
                                b->dc + (acc[i * 4 + j] >> 4));
                }
            } else { /* inter: MC (+ residual) / lowered copy */
                aot_acc(s, b, acc);
                for (int i = 0; i < 4; i++) {
                    for (int j = 0; j < 4; j++) {
                        int gx = bx * 4 + j, gy = by * 4 + i;
                        int pred;
                        if (b->refsel == 0)
                            pred = mc_sample(ref0, pw, ph, 2 * gx + b->mvx,
                                             2 * gy + b->mvy);
                        else if (b->refsel == 1)
                            pred = mc_sample(ref1, pw, ph, 2 * gx + b->mvx,
                                             2 * gy + b->mvy);
                        else {
                            int f = mc_sample(ref0, pw, ph, 2 * gx + b->mvx,
                                              2 * gy + b->mvy);
                            int bk = mc_sample(ref1, pw, ph, 2 * gx + b->mv2x,
                                               2 * gy + b->mv2y);
                            pred = (f + bk + 1) >> 1;
                        }
                        out[i * pw + j] =
                            (uint8_t)clip_u8(pred + (acc[i * 4 + j] >> 4));
                    }
                }
            }
        }
    }
}

/* nest from luma effective-DC grid (FORMAT.md §6.1) */
static void build_nest(Dec *s, int nest_x, int nest_y) {
    int bw = s->bw[0], bh = s->bh[0];
    for (int y = 0; y < s->nest_h; y++) {
        int ry = (nest_y + y) % bh;
        for (int x = 0; x < s->nest_w; x++) {
            int rx = (nest_x + x) % bw;
            s->nest[y * s->nest_w + x] = s->blk[0][ry * bw + rx].dc;
        }
    }
}


#define N_STREAMS 6
#define FRAME_HDR (12 + 4 * N_STREAMS)

/* One slice's MB rows (FORMAT.md §7.1/§9); MV chain resets per slice. */
static void mb_rows(char ftype, Streams *st, MB *mbs, int mw,
                    int ms0, int ms1) {
    int32_t px = 0, py = 0;
    for (int my = ms0; my < ms1; my++) {
        for (int mx = 0; mx < mw; mx++) {
            MB *mb = &mbs[(size_t)my * mw + mx];
            memset(mb, 0, sizeof *mb);
            unsigned t = br_bits(&st->mbt, 2);
            if (t == 3) die("mbtype 3 invalid");
            mb->mbtype = (uint8_t)t;
            if (t == MB_COPY) {
                mb->refsel = (ftype == 'P') ? 1 : 0;
            } else if (t == MB_INTER) {
                if (ftype == 'B') {
                    unsigned rs = br_bits(&st->mbt, 2);
                    if (rs == 3) die("refsel 3 invalid");
                    mb->refsel = (uint8_t)rs;
                } else {
                    mb->refsel = 1;
                }
                /* the chain value wraps to signed 16-bit after every
                 * delta (FORMAT.md 7.2) -- keeps the accumulator defined
                 * for arbitrarily long hostile chains */
                px = (int16_t)(px + huff_delta(&st->mv));
                py = (int16_t)(py + huff_delta(&st->mv));
                mb->mvx = (int16_t)px;
                mb->mvy = (int16_t)py;
                if (ftype == 'B' && mb->refsel == 2) {
                    px = (int16_t)(px + huff_delta(&st->mv));
                    py = (int16_t)(py + huff_delta(&st->mv));
                    mb->mv2x = (int16_t)px;
                    mb->mv2y = (int16_t)py;
                }
            }
        }
    }
}

/* Position stream readers on slice sl's segments (FORMAT.md §9). */
static void init_slice_streams(Streams *st, const uint8_t *sp[N_STREAMS],
                               const size_t sn[N_STREAMS], const uint8_t *seg,
                               int sl, int n_slices) {
    (void)sn;
    st->bn_zero_run = 0;
    for (int k = 0; k < N_STREAMS; k++) {
        size_t start = 0, len = 0;
        for (int i = 0; i < sl; i++)
            start += be32(seg + 4 * (k * n_slices + i));
        len = be32(seg + 4 * (k * n_slices + sl));
        const uint8_t *d = sp[k] + start;
        switch (k) {
        case 0: huff_init(&st->bn, d, len); break;
        case 1: huff_init(&st->dc, d, len); break;
        case 2: br_init(&st->aux, d, len); break;
        case 3: br_init(&st->mbt, d, len); break;
        case 4: huff_init(&st->mv, d, len); break;
        default: break;
        }
    }
}

/* ---------------- frame decode (reference L3) ---------------- */

static uint8_t *decode_frame(Dec *s, char ftype, const uint8_t *p, size_t n,
                             uint32_t *display_id) {
    if (n < FRAME_HDR) die("frame payload too short");
    *display_id = be32(p);
    int nest_x = be16(p + 4), nest_y = be16(p + 6);
    int dc_shift = p[8];
    int n_slices = p[9] > 1 ? p[9] : 1;
    if (dc_shift > 7) die("dc_shift out of range");
    if (n_slices > s->mh) die("slice count exceeds MB rows");
    if (be16(p + 10) != 0) die("reserved frame-header field must be zero");
    const uint8_t *sp[N_STREAMS];
    size_t sn[N_STREAMS];
    size_t off = FRAME_HDR;
    const uint8_t *seg = NULL; /* 6 x S u32 segment sub-table (§9) */
    if (n_slices > 1) {
        size_t sub = 4u * N_STREAMS * (size_t)n_slices;
        if (off + sub > n) die("truncated slice sub-table");
        seg = p + off;
        off += sub;
    }
    if (be32(p + 12 + 4 * 5) != 0) die("reserved stream 5 must be empty");
    for (int i = 0; i < N_STREAMS; i++) {
        sn[i] = be32(p + 12 + 4 * i);
        if (off + sn[i] > n) die("stream overruns payload");
        sp[i] = p + off;
        off += sn[i];
        if (seg) { /* validate the segment sums */
            size_t tot = 0;
            for (int sl = 0; sl < n_slices; sl++)
                tot += be32(seg + 4 * (i * n_slices + sl));
            if (tot != sn[i]) die("slice segments do not sum to stream size");
        }
    }
    if (off != n) die("trailing bytes after streams");

    Streams st;
    st.bn_zero_run = 0;
    if (n_slices == 1) {
        huff_init(&st.bn, sp[0], sn[0]);
        huff_init(&st.dc, sp[1], sn[1]);
        br_init(&st.aux, sp[2], sn[2]);
        br_init(&st.mbt, sp[3], sn[3]);
        huff_init(&st.mv, sp[4], sn[4]);
    }

    /* MB layer (FORMAT.md §7.1) + per-plane entropy, per slice (§9) */
    MB *mbs = NULL;
    if (ftype != 'I') {
        if (!s->ref_last) die("P/B frame without reference");
        if (ftype == 'B' && !s->ref_prev) die("B frame without two references");
        mbs = calloc((size_t)s->mh * s->mw, sizeof(MB));
        if (!mbs) die("oom");
    }
    for (int sl = 0; sl < n_slices; sl++) {
        Streams sst;
        Streams *stp;
        if (n_slices > 1) {
            init_slice_streams(&sst, sp, sn, seg, sl, n_slices);
            stp = &sst;
        } else {
            stp = &st;
        }
        int ms0 = sl * s->mh / n_slices, ms1 = (sl + 1) * s->mh / n_slices;
        if (ftype != 'I') mb_rows(ftype, stp, mbs, s->mw, ms0, ms1);
        for (int pi = 0; pi < 3; pi++) {
            int rpm = (pi > 0 && s->h_samp == 2) ? 1 : 2; /* block rows/MB row */
            entropy_plane(s, pi, ftype, dc_shift, stp, mbs,
                          ms0 * rpm, ms1 * rpm);
        }
    }
    free(mbs);

    if (ftype == 'I') build_nest(s, nest_x, nest_y);

    uint8_t *frame;
    if (ftype == 'B') {
        frame = s->buf[3];
    } else {
        frame = s->buf[s->free_buf];
        s->free_buf = (s->free_buf + 1) % 3;
    }
    for (int pi = 0; pi < 3; pi++) {
        const uint8_t *r0 = NULL, *r1 = NULL;
        if (ftype != 'I') {
            r1 = plane_ptr(s, s->ref_last, pi);
            r0 = (ftype == 'B') ? plane_ptr(s, s->ref_prev, pi) : r1;
        }
        synth_plane(s, pi, plane_ptr(s, frame, pi), r0, r1);
    }
    if (ftype != 'B') {
        s->ref_prev = s->ref_last;
        s->ref_last = frame;
    }
    return frame;
}

/* ---------------- audio (FORMAT.md §8) ---------------- */

static const int STEP_TABLE[89] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,
    19,    21,    23,    25,    28,    31,    34,    37,    41,    45,
    50,    55,    60,    66,    73,    80,    88,    97,    107,   118,
    130,   143,   157,   173,   190,   209,   230,   253,   279,   307,
    337,   371,   408,   449,   494,   544,   598,   658,   724,   796,
    876,   963,   1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,
    2272,  2499,  2749,  3024,  3327,  3660,  4026,  4428,  4871,  5358,
    5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};
static const int INDEX_TABLE[8] = {-1, -1, -1, -1, 2, 4, 6, 8};

static void decode_audio(const uint8_t *p, size_t n, int channels, FILE *out) {
    if (n < 4u + 4u * channels) die("audio record too short");
    uint32_t n_samples = be32(p);
    int pred[2] = {0, 0}, idx[2] = {0, 0};
    size_t off = 4;
    for (int c = 0; c < channels; c++) {
        pred[c] = (int16_t)be16(p + off);
        idx[c] = p[off + 2];
        if (idx[c] > 88) die("step_index out of range");
        off += 4;
    }
    size_t need = ((size_t)n_samples * channels + 1) / 2;
    if (n - off < need) die("audio record truncated");
    const uint8_t *d = p + off;
    size_t ni = 0;
    for (uint32_t s = 0; s < n_samples; s++) {
        for (int c = 0; c < channels; c++) {
            int nib = (ni & 1) ? (d[ni >> 1] & 0xF) : (d[ni >> 1] >> 4);
            ni++;
            int step = STEP_TABLE[idx[c]];
            int diff = step >> 3;
            if (nib & 1) diff += step >> 2;
            if (nib & 2) diff += step >> 1;
            if (nib & 4) diff += step;
            pred[c] += (nib & 8) ? -diff : diff;
            if (pred[c] < -32768) pred[c] = -32768;
            if (pred[c] > 32767) pred[c] = 32767;
            idx[c] += INDEX_TABLE[nib & 7];
            if (idx[c] < 0) idx[c] = 0;
            if (idx[c] > 88) idx[c] = 88;
            if (out) {
                uint8_t le[2] = {(uint8_t)(pred[c] & 0xFF),
                                 (uint8_t)((pred[c] >> 8) & 0xFF)};
                fwrite(le, 1, 2, out);
            }
        }
    }
}

/* ---------------- container walk + main (reference L0/L1) ---------------- */

static uint32_t fnv1a(const uint8_t *d, size_t n, uint32_t h) {
    for (size_t i = 0; i < n; i++) {
        h ^= d[i];
        h *= 16777619u;
    }
    return h;
}

/* Position-weighted u32 sum (mod 2^32): csum = sum_i (d[i]+1) * (i*K + 1),
 * K = 2654435761 (Knuth). Unlike FNV-1a this is a commutative sum of
 * independent terms, so the device pipeline computes the identical value as one
 * on-device reduction and transfers 4 bytes per frame instead of the full
 * YUV (hvqm4_jax/utils/hashing.py `wsum32` is the other implementation). */
static uint32_t wsum32(const uint8_t *d, size_t n) {
    uint32_t acc = 0;
    for (size_t i = 0; i < n; i++)
        acc += (uint32_t)(d[i] + 1u) * ((uint32_t)i * 2654435761u + 1u);
    return acc;
}

typedef struct {
    int hash, csum, bench;
    FILE *yuv, *audio;
} Opts;

static int decode_file(const uint8_t *f, size_t n, Opts *o) {
    if (n < 0x44) die("file shorter than header");
    /* the magic is NUL-padded to 16 bytes (FORMAT.md 1): check all of it */
    if (memcmp(f, "HVQM4 1.3\0\0\0\0\0\0", 16) != 0 &&
        memcmp(f, "HVQM4 1.5\0\0\0\0\0\0", 16) != 0)
        die("bad magic");
    if (be32(f + 0x10) != 0x44) die("bad header_size");
    if (be32(f + 0x14) != n - 0x44) die("body_size mismatch");
    uint32_t blocks = be32(f + 0x18);
    int w = be16(f + 0x34), h = be16(f + 0x36);
    int hs = f[0x38], vs = f[0x39];
    int channels = f[0x3C];
    if ((hs != 1 && hs != 2) || hs != vs) die("unsupported sampling");
    if (w % 8 || h % 8 || !w || !h) die("bad dimensions");
    if (channels > 2) die("bad channel count");

    Dec s;
    dec_init(&s, w, h, hs, vs);
    int frames = 0;
    size_t off = 0x44;
    for (uint32_t bi = 0; bi < blocks; bi++) {
        if (off + 8 > n) die("truncated block header");
        uint32_t bsize = be32(f + off);
        int n_audio = be16(f + off + 4), n_video = be16(f + off + 6);
        size_t end = off + 8 + bsize;
        if (end > n) die("block overruns file");
        off += 8;
        dec_reset_refs(&s); /* GOP seek point */
        for (int r = 0; r < n_audio + n_video; r++) {
            if (off + 8 > end) die("truncated record header");
            int mtype = be16(f + off);
            int sub = be16(f + off + 2);
            uint32_t psize = be32(f + off + 4);
            off += 8;
            if (off + psize > end) die("record overruns block");
            if (mtype == 0) {
                if (r >= n_audio) die("audio record out of order");
                if (channels) decode_audio(f + off, psize, channels, o->audio);
            } else if (mtype == 1) {
                if (r < n_audio) die("video record out of order");
                char ft = sub == 0x10 ? 'I' : sub == 0x20 ? 'P'
                          : sub == 0x30 ? 'B' : 0;
                if (!ft) die("bad video subtype");
                uint32_t disp;
                uint8_t *frame = decode_frame(&s, ft, f + off, psize, &disp);
                frames++;
                if (o->yuv) fwrite(frame, 1, frame_bytes(&s), o->yuv);
                if (o->hash)
                    printf("frame %d %c disp=%u hash=%08x\n", frames - 1, ft,
                           disp, fnv1a(frame, frame_bytes(&s), 2166136261u));
                if (o->csum)
                    printf("frame %d %c disp=%u csum=%08x\n", frames - 1, ft,
                           disp, wsum32(frame, frame_bytes(&s)));
            } else {
                die("bad media type");
            }
            off += psize;
        }
        if (off != end) die("trailing bytes in block");
    }
    if (off != n) die("trailing bytes after last block");
    dec_free(&s);
    return frames;
}

int main(int argc, char **argv) {
    Opts o = {0, 0, 0, NULL, NULL};
    const char *in = NULL, *out = NULL;
    for (int i = 1; i < argc; i++) {
        if (!strcmp(argv[i], "--hash")) {
            o.hash = 1;
        } else if (!strcmp(argv[i], "--csum")) {
            o.csum = 1;
        } else if (!strcmp(argv[i], "--bench")) {
            if (++i >= argc) die("--bench needs a count");
            o.bench = atoi(argv[i]);
        } else if (!strcmp(argv[i], "--audio")) {
            if (++i >= argc) die("--audio needs a path");
            o.audio = fopen(argv[i], "wb");
            if (!o.audio) die("cannot open audio output");
        } else if (!in) {
            in = argv[i];
        } else if (!out) {
            out = argv[i];
        } else {
            die("too many arguments");
        }
    }
    if (!in) die("usage: hvqm4_oracle [--hash] [--csum] [--bench N] [--audio f] in.h4m [out.yuv]");

    FILE *fp = fopen(in, "rb");
    if (!fp) die("cannot open input");
    fseek(fp, 0, SEEK_END);
    long fn = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    uint8_t *data = malloc((size_t)fn);
    if (!data || fread(data, 1, (size_t)fn, fp) != (size_t)fn) die("read failed");
    fclose(fp);

    if (out) {
        o.yuv = fopen(out, "wb");
        if (!o.yuv) die("cannot open output");
    }

    if (o.bench > 0) {
        struct timespec t0, t1;
        int frames = 0;
        clock_gettime(CLOCK_MONOTONIC, &t0);
        for (int i = 0; i < o.bench; i++)
            frames += decode_file(data, (size_t)fn, &o);
        clock_gettime(CLOCK_MONOTONIC, &t1);
        double dt = (double)(t1.tv_sec - t0.tv_sec) +
                    1e-9 * (double)(t1.tv_nsec - t0.tv_nsec);
        printf("{\"frames\": %d, \"seconds\": %.6f, \"fps\": %.2f}\n", frames,
               dt, frames / dt);
    } else {
        decode_file(data, (size_t)fn, &o);
    }
    if (o.yuv) fclose(o.yuv);
    if (o.audio) fclose(o.audio);
    free(data);
    return 0;
}
