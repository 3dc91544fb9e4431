/* Per-lane FFV1 range-coder scans, shared by the CUDA kernels
 * (ffv1_cuda.cu, one GPU thread per lane) and their host build
 * (ffv1_scan_host.cc, the CPU tests' handle on the same arithmetic).
 *
 * A lane is one slice bitstream.  Both routines are the serial coder of
 * ffv1_native.c (put_symbol / get_symbol / decode_line) with the I/O
 * contracts of the XLA lane scans they stand in for:
 *
 *   encode: tpu_ffv1/tpu/rc_scan_lanes.py rc_encode_scan_lanes_unrolled
 *           (coded widths <= 10) and rc_encode_scan_lanes_ext (11..17).
 *           Every emitted byte lands at the slot the XLA scan gives the
 *           same decision (rc_scan_fast.chain_order / ext_slots) as
 *           prov | 1 << 20; slots that emit nothing stay 0, so the
 *           packed (N, S, L) output feeds finalize_packed unchanged.
 *   decode: tpu_ffv1/tpu/dec_scan_lanes.py rc_decode_planes_lanes,
 *           including its exponent cap of e_max + 1 decisions.
 */
#ifndef FFV1_SCAN_H
#define FFV1_SCAN_H

#include <stdint.h>

#if defined(__CUDACC__)
#define FFV1_HD __host__ __device__ __forceinline__
#else
#define FFV1_HD static inline
#endif

FFV1_HD int ffv1_min(int a, int b) { return a < b ? a : b; }

FFV1_HD int ffv1_log2(int a)
{
#if defined(__CUDA_ARCH__)
    return 31 - __clz(a);
#else
    return 31 - __builtin_clz((unsigned)a);
#endif
}

/* Slots per pixel of the packed encode output: chain_order(bits) has
 * 3 * bits entries, ext_slots(bits) 2 * bits + 1. */
FFV1_HD int ffv1_slot_count(int bits)
{
    return bits <= 10 ? 3 * bits : 2 * bits + 1;
}

/* ------------------------------------------------------------ encode */

typedef struct {
    int low, rng;
    const uint8_t *one, *zero;
    int32_t *px;       /* packed output of the current pixel, slot 0 */
    int64_t sstride;   /* distance between slots (the lane count) */
    int S;
} Ffv1Enc;

FFV1_HD void ffv1_put(Ffv1Enc *c, uint8_t *st, int bit, int slot)
{
    const int s = *st;
    const int r1 = (c->rng * s) >> 8;
    int nl = c->low, nr;
    if (bit) {
        nl += c->rng - r1;
        nr = r1;
        *st = c->one[s];
    } else {
        nr = c->rng - r1;
        *st = c->zero[s];
    }
    if (nr < 0x100) {
        slot = slot < c->S ? slot : c->S - 1;  /* only |v| >= 2^bits */
        c->px[slot * c->sstride] =
            (nl >> 8) | ((nl & 0xFF) ? 1 << 16 : 0) | 1 << 20;
        nl = (nl & 0xFF) << 8;
        nr <<= 8;
    }
    c->low = nl;
    c->rng = nr;
}

/* put_symbol(state row, v, signed) of ffv1enc.c:185-231. */
FFV1_HD void ffv1_encode_pixel(Ffv1Enc *c, uint8_t *row, int v, int e_max,
                               int ext)
{
    int a, e, i, j;
    const int mbase = 2 + e_max;            /* first mantissa slot */
    if (v == 0) {
        ffv1_put(c, row, 1, 0);
        return;
    }
    a = v < 0 ? -v : v;
    e = ffv1_log2(a);
    ffv1_put(c, row, 0, 0);
    for (j = 0; j <= e; j++)
        ffv1_put(c, row + 1 + ffv1_min(j, 9), j < e, 1 + j);
    for (i = e - 1; i >= 0; i--) {
        int slot;
        if (!ext)
            slot = mbase + e_max - 1 - i;
        else if (i >= 9)
            slot = mbase + e - 1 - i;       /* the repeated row 31 */
        else
            slot = mbase + e_max - 9 + 8 - i;
        ffv1_put(c, row + 22 + ffv1_min(i, 9), (a >> i) & 1, slot);
    }
    ffv1_put(c, row + 11 + ffv1_min(e, 10), v < 0,
             ext ? 2 * e_max + 2 : mbase + e_max + e);
}

/* One lane: ctx/diff/act are the lane's rows of the (L, N) streams,
 * states its (CC, 32) table, out the packed (N, S, L) output offset to
 * the lane (zeroed by the caller). */
FFV1_HD void ffv1_encode_lane(const int32_t *ctx, const int32_t *diff,
                              const uint8_t *act, int64_t n,
                              uint8_t *states, int bits, int *low,
                              int *rng, const uint8_t *one,
                              const uint8_t *zero, int32_t *out,
                              int64_t lanes)
{
    Ffv1Enc c;
    int64_t i;
    const int e_max = bits - 1;
    const int ext = bits > 10;
    c.low = *low;
    c.rng = *rng;
    c.one = one;
    c.zero = zero;
    c.sstride = lanes;
    c.S = ffv1_slot_count(bits);
    for (i = 0; i < n; i++) {
        if (!act[i])
            continue;
        c.px = out + i * c.S * lanes;
        ffv1_encode_pixel(&c, states + (int64_t)ctx[i] * 32, diff[i],
                          e_max, ext);
    }
    *low = c.low;
    *rng = c.rng;
}

/* ------------------------------------------------------------ decode */

typedef struct {
    int low, rng, pos;
    const uint8_t *buf;
    int cap;
    const uint8_t *one, *zero;
} Ffv1Dec;

/* get_rac + one refill (rangecoder.h:104-145); reads past the buffer
 * return 0, as the XLA scan's zero-padded byte window does. */
FFV1_HD int ffv1_get(Ffv1Dec *d, uint8_t *st)
{
    const int s = *st;
    const int r1 = (d->rng * s) >> 8;
    const int r0 = d->rng - r1;
    const int bit = d->low >= r0;
    if (bit) {
        d->low -= r0;
        d->rng = r1;
        *st = d->one[s];
    } else {
        d->rng = r0;
        *st = d->zero[s];
    }
    if (d->rng < 0x100) {
        d->low = (d->low << 8) + (d->pos < d->cap ? d->buf[d->pos] : 0);
        d->rng <<= 8;
        d->pos++;
    }
    return bit;
}

/* get_symbol(state row, signed) of ffv1dec.c:42-63, with the lane
 * scan's cap of e_max + 1 exponent decisions. */
FFV1_HD int ffv1_decode_symbol(Ffv1Dec *d, uint8_t *row, int e_max)
{
    int e = 0, a = 1, j, m;
    if (ffv1_get(d, row))
        return 0;
    for (j = 0; j <= e_max; j++) {
        if (!ffv1_get(d, row + 1 + ffv1_min(j, 9)))
            break;
        e++;
    }
    m = ffv1_min(e, e_max);
    for (j = 0; j < m; j++) {
        int i = e - 1 - j;
        a += a + ffv1_get(d, row + 22 + (i < 0 ? 0 : ffv1_min(i, 9)));
    }
    return ffv1_get(d, row + 11 + ffv1_min(e, 10)) ? -a : a;
}

/* All planes of one lane (decode_line of ffv1dec.c:100-181 over a
 * two-row ring, fresh per plane).  specs holds (w, h, state row base)
 * per plane; ring has room for 2 * (max w + 6) samples; out receives
 * the planes back to back, row-major. */
FFV1_HD void ffv1_decode_lane(Ffv1Dec *d, uint8_t *states,
                              const int32_t *specs, int nplanes,
                              const int32_t *qt, int five, int bits,
                              int32_t *ring, int32_t *out)
{
    const int mask = (1 << bits) - 1;
    const int e_max = bits - 1;
    int p, x, y;
    for (p = 0; p < nplanes; p++) {
        const int w = specs[3 * p], h = specs[3 * p + 1];
        const int base = specs[3 * p + 2];
        int32_t *s0 = ring + 3, *s1 = ring + (w + 6) + 3;
        for (x = 0; x < 2 * (w + 6); x++)
            ring[x] = 0;
        for (y = 0; y < h; y++) {
            int32_t *prev = s1, *cur = s0;
            s0 = prev;
            s1 = cur;
            cur[-1] = prev[0];
            prev[w] = prev[w - 1];
            for (x = 0; x < w; x++) {
                const int Lv = cur[x - 1], T = prev[x];
                const int LT = prev[x - 1], RT = prev[x + 1];
                int ctx = qt[(Lv - LT) & 0xFF] +
                          qt[256 + ((LT - T) & 0xFF)] +
                          qt[512 + ((T - RT) & 0xFF)];
                int diff, m, lo, hi, val;
                if (five)
                    ctx += qt[768 + ((cur[x - 2] - Lv) & 0xFF)] +
                           qt[1024 + ((cur[x] - T) & 0xFF)];
                diff = ffv1_decode_symbol(
                    d, states + (int64_t)(base + (ctx < 0 ? -ctx : ctx)) * 32,
                    e_max);
                if (ctx < 0)
                    diff = -diff;
                /* median predictor, ffv1dec.c mid_pred */
                m = Lv + T - LT;
                lo = Lv < m ? Lv : m;
                hi = Lv < m ? m : Lv;
                lo = lo < T ? lo : T;
                hi = hi > T ? hi : T;
                val = (Lv + m + T - lo - hi + diff) & mask;
                if (bits == 16)    /* int16_t sample rows */
                    val = ((val + 0x8000) & 0xFFFF) - 0x8000;
                cur[x] = val;
                out[(int64_t)y * w + x] = val;
            }
        }
        out += (int64_t)w * h;
    }
}

#endif /* FFV1_SCAN_H */
