/*
 * tpu_ffv1 native host runtime: per-slice FFV1 hot loops in C.
 *
 * This is the framework's production host path (the reference's analog
 * role: libavcodec's C codec core).  The Python spec layer
 * (tpu_ffv1/codec/slice_codec.py) is the bit-exactness oracle; this file
 * implements the same semantics for speed.  Exposed with a small C ABI
 * consumed via ctypes (tpu_ffv1/native.py).
 *
 * Behavioral parity references (re-derived):
 *   rangecoder.h:52-145, ffv1.h:148-224, ffv1enc.c:185-473,
 *   ffv1dec.c:42-280, golomb.h:268-561.
 */
#include <stdint.h>
#include <string.h>
#include <math.h>
#include <stdlib.h>

#define API __attribute__((visibility("default")))

/* ---------------- range coder ---------------- */

typedef struct {
    int32_t low, range, ocount, obyte; /* obyte < 0: none pending */
    int64_t pos;                       /* write/read byte position  */
} RcState;

typedef struct {
    RcState *st;
    uint8_t *buf;
    int64_t cap;
    const uint8_t *one, *zero;
    int overflow;
} RcEnc;

static inline void renorm_enc(RcEnc *c)
{
    RcState *s = c->st;
    while (s->range < 0x100) {
        if (s->obyte < 0) {
            s->obyte = s->low >> 8;
        } else if (s->low <= 0xFF00) {
            if (s->pos + 1 + s->ocount > c->cap) { c->overflow = 1; return; }
            c->buf[s->pos++] = (uint8_t)s->obyte;
            while (s->ocount) { c->buf[s->pos++] = 0xFF; s->ocount--; }
            s->obyte = s->low >> 8;
        } else if (s->low >= 0x10000) {
            if (s->pos + 1 + s->ocount > c->cap) { c->overflow = 1; return; }
            c->buf[s->pos++] = (uint8_t)(s->obyte + 1);
            while (s->ocount) { c->buf[s->pos++] = 0x00; s->ocount--; }
            s->obyte = (s->low >> 8) & 0xFF;
        } else {
            s->ocount++;
        }
        s->low = (s->low & 0xFF) << 8;
        s->range <<= 8;
    }
}

static inline void put_rac(RcEnc *c, uint8_t *state, int bit)
{
    RcState *s = c->st;
    int range1 = (s->range * (*state)) >> 8;
    if (!bit) {
        s->range -= range1;
        *state = c->zero[*state];
    } else {
        s->low += s->range - range1;
        s->range = range1;
        *state = c->one[*state];
    }
    renorm_enc(c);
}

typedef struct {
    RcState *st;
    const uint8_t *buf;
    int64_t len;
    const uint8_t *one, *zero;
} RcDec;

static inline void refill(RcDec *c)
{
    RcState *s = c->st;
    if (s->range < 0x100) {
        s->range <<= 8;
        s->low <<= 8;
        if (s->pos < c->len)
            s->low += c->buf[s->pos];
        s->pos++;
    }
}

static inline int get_rac(RcDec *c, uint8_t *state)
{
    RcState *s = c->st;
    int range1 = (s->range * (*state)) >> 8;
    s->range -= range1;
    if (s->low < s->range) {
        *state = c->zero[*state];
        refill(c);
        return 0;
    }
    s->low -= s->range;
    *state = c->one[*state];
    s->range = range1;
    refill(c);
    return 1;
}

/* ---------------- symbol layer ---------------- */

static inline int ff_log2(unsigned v)
{
    return v ? 31 - __builtin_clz(v) : 0;
}

static void put_symbol(RcEnc *c, uint8_t *state, int v, int is_signed)
{
    int i;
    if (v) {
        const int a = v < 0 ? -v : v;
        const int e = ff_log2(a);
        put_rac(c, state + 0, 0);
        if (e <= 9) {
            for (i = 0; i < e; i++) put_rac(c, state + 1 + i, 1);
            put_rac(c, state + 1 + i, 0);
            for (i = e - 1; i >= 0; i--)
                put_rac(c, state + 22 + i, (a >> i) & 1);
            if (is_signed) put_rac(c, state + 11 + e, v < 0);
        } else {
            for (i = 0; i < e; i++)
                put_rac(c, state + 1 + (i < 9 ? i : 9), 1);
            put_rac(c, state + 1 + 9, 0);
            for (i = e - 1; i >= 0; i--)
                put_rac(c, state + 22 + (i < 9 ? i : 9), (a >> i) & 1);
            if (is_signed) put_rac(c, state + 11 + 10, v < 0);
        }
    } else {
        put_rac(c, state + 0, 1);
    }
}

static int get_symbol(RcDec *c, uint8_t *state, int is_signed)
{
    if (get_rac(c, state + 0))
        return 0;
    {
        int i, e = 0, a = 1, neg;
        while (get_rac(c, state + 1 + (e < 9 ? e : 9))) {
            e++;
            if (e > 31) return 0; /* corrupt; caller checks byte counts */
        }
        for (i = e - 1; i >= 0; i--)
            a += a + get_rac(c, state + 22 + (i < 9 ? i : 9));
        neg = is_signed && get_rac(c, state + 11 + (e < 10 ? e : 10));
        return neg ? -a : a;
    }
}

/* ---------------- bit I/O (MSB first) ---------------- */

typedef struct {
    uint8_t *buf;
    int64_t cap;
    int64_t pos_bits;
    uint64_t acc;
    int nacc;
    int overflow;
} BitWr;

static inline void put_bits(BitWr *b, int n, uint32_t v)
{
    b->acc = (b->acc << n) | v;
    b->nacc += n;
    while (b->nacc >= 8) {
        b->nacc -= 8;
        if ((b->pos_bits >> 3) >= b->cap) { b->overflow = 1; return; }
        b->buf[b->pos_bits >> 3] = (uint8_t)(b->acc >> b->nacc);
        b->pos_bits += 8;
    }
    b->acc &= (1ULL << b->nacc) - 1;
}

typedef struct {
    const uint8_t *buf;
    int64_t len;
    int64_t pos;               /* bit position */
} BitRd;

static inline int get_bit(BitRd *b)
{
    int64_t byte_i = b->pos >> 3;
    int bit = 0;
    if (byte_i < b->len)
        bit = (b->buf[byte_i] >> (7 - (b->pos & 7))) & 1;
    b->pos++;
    return bit;
}

static inline uint32_t get_bits_n(BitRd *b, int n)
{
    uint32_t v = 0;
    while (n--) v = (v << 1) | get_bit(b);
    return v;
}

/* ---------------- golomb-rice ---------------- */

static const uint8_t log2_run[41] = {
    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24,
};

static void set_ur_golomb(BitWr *b, int i, int k, int limit, int esc_len)
{
    int e = i >> k;
    if (e < limit)
        put_bits(b, e + k + 1, (1 << k) + (i & ((1 << k) - 1)));
    else
        put_bits(b, limit + esc_len, i - limit + 1);
}

static void set_sr_golomb(BitWr *b, int i, int k, int limit, int esc_len)
{
    int v = i >= 0 ? 2 * i : -2 * i - 1;
    set_ur_golomb(b, v, k, limit, esc_len);
}

static int get_ur_golomb(BitRd *b, int k, int limit, int esc_len)
{
    int e = 0;
    while (e < limit) {
        int64_t p = b->pos + e;
        int64_t byte_i = p >> 3;
        int bit = byte_i < b->len ?
            (b->buf[byte_i] >> (7 - (p & 7))) & 1 : 0;
        if (bit) break;
        e++;
    }
    if (e < limit) {
        int m;
        b->pos += e + 1;
        m = k ? (int)get_bits_n(b, k) : 0;
        return (e << k) | m;
    }
    b->pos += limit;
    return (int)get_bits_n(b, esc_len) + limit - 1;
}

static int get_sr_golomb(BitRd *b, int k, int limit, int esc_len)
{
    int v = get_ur_golomb(b, k, limit, esc_len);
    return (v >> 1) ^ -(v & 1);
}

/* VLC state: layout matches tpu_ffv1.core.golomb.VLC_STATE_DTYPE */
typedef struct {
    int16_t drift;
    uint16_t error_sum;
    int8_t bias;
    uint8_t count;
} VlcState;

static inline int folds(int diff, int bits)
{
    if (bits == 8) return (int8_t)diff;
    diff += 1 << (bits - 1);
    diff &= (1 << bits) - 1;
    return diff - (1 << (bits - 1));
}

static void update_vlc_state(VlcState *s, int v)
{
    int drift = s->drift, count = s->count, bias = s->bias;
    int esum = (s->error_sum + (v < 0 ? -v : v)) & 0xFFFF;
    drift += v;
    if (count == 128) {
        count >>= 1;
        drift >>= 1;
        esum >>= 1;
    }
    count++;
    if (drift <= -count) {
        if (bias > -128) bias--;
        drift += count;
        if (drift <= -count) drift = -count + 1;
    } else if (drift > 0) {
        if (bias < 127) bias++;
        drift -= count;
        if (drift > 0) drift = 0;
    }
    s->drift = (int16_t)drift;
    s->error_sum = (uint16_t)esum;
    s->bias = (int8_t)bias;
    s->count = (uint8_t)count;
}

static inline int vlc_k(const VlcState *s)
{
    int k = 0, i = s->count;
    while (i < s->error_sum) { k++; i += i; }
    return k;
}

static void put_vlc_symbol(BitWr *b, VlcState *s, int v, int bits)
{
    int k, code;
    v = folds(v - s->bias, bits);
    k = vlc_k(s);
    code = v ^ ((2 * s->drift + s->count) >> 31);
    set_sr_golomb(b, code, k, 12, bits);
    update_vlc_state(s, v);
}

static int get_vlc_symbol(BitRd *b, VlcState *s, int bits)
{
    int k = vlc_k(s);
    int v = get_sr_golomb(b, k, 12, bits);
    int ret;
    v ^= (2 * s->drift + s->count) >> 31;
    ret = folds(v + s->bias, bits);
    update_vlc_state(s, v);
    return ret;
}

/* ---------------- predictor / context ---------------- */

static inline int mid_pred(int a, int b, int c)
{
    if (a > b) {
        if (c > b) b = c > a ? a : c;
    } else {
        if (b > c) b = c > a ? c : a;
    }
    return b;
}

static inline int get_ctx(const int16_t *qt, const int16_t *cur,
                          const int16_t *last, const int16_t *last2,
                          int five)
{
    const int LT = last[-1], Tv = last[0], RT = last[1], L = cur[-1];
    int c = qt[0 * 256 + ((L - LT) & 0xFF)] +
            qt[1 * 256 + ((LT - Tv) & 0xFF)] +
            qt[2 * 256 + ((Tv - RT) & 0xFF)];
    if (five) {
        const int TT = last2[0], LL = cur[-2];
        c += qt[3 * 256 + ((LL - L) & 0xFF)] +
             qt[4 * 256 + ((TT - Tv) & 0xFF)];
    }
    return c;
}

/* ---------------- line coding ---------------- */

typedef struct {
    int ac;                /* 0 golomb else range */
    int bits;
    int run_index;
    int slice_coding_mode;
    const int16_t *qt;     /* 5*256 */
    uint8_t *states;       /* context_count*32 (range) */
    VlcState *vlc;         /* context_count (golomb) */
    int five;
    RcEnc *re;
    BitWr *bw;
    RcDec *rd;
    BitRd *br;
} LineCtx;

static int encode_line(LineCtx *lc, int16_t **sample, int w, int bits)
{
    int x, run_index = lc->run_index, run_count = 0, run_mode = 0;

    if (lc->slice_coding_mode == 1) {
        for (x = 0; x < w; x++) {
            int i, v = sample[0][x];
            for (i = bits - 1; i >= 0; i--) {
                uint8_t st = 128;
                put_rac(lc->re, &st, (v >> i) & 1);
            }
        }
        return lc->re->overflow ? -1 : 0;
    }

    for (x = 0; x < w; x++) {
        int context = get_ctx(lc->qt, sample[0] + x, sample[1] + x,
                              sample[2] + x, lc->five);
        int diff = sample[0][x] -
            mid_pred(sample[0][x - 1],
                     sample[0][x - 1] + sample[1][x] - sample[1][x - 1],
                     sample[1][x]);
        if (context < 0) { context = -context; diff = -diff; }
        diff = folds(diff, bits);

        if (lc->ac) {
            put_symbol(lc->re, lc->states + (size_t)context * 32, diff, 1);
            if (lc->re->overflow) return -1;
        } else {
            if (context == 0) run_mode = 1;
            if (run_mode) {
                if (diff) {
                    while (run_count >= 1 << log2_run[run_index]) {
                        run_count -= 1 << log2_run[run_index];
                        run_index++;
                        put_bits(lc->bw, 1, 1);
                    }
                    put_bits(lc->bw, 1 + log2_run[run_index],
                             (uint32_t)run_count);
                    if (run_index) run_index--;
                    run_count = 0;
                    run_mode = 0;
                    if (diff > 0) diff--;
                } else {
                    run_count++;
                }
            }
            if (run_mode == 0)
                put_vlc_symbol(lc->bw, lc->vlc + context, diff, bits);
            if (lc->bw->overflow) return -1;
        }
    }
    if (run_mode) {
        while (run_count >= 1 << log2_run[run_index]) {
            run_count -= 1 << log2_run[run_index];
            run_index++;
            put_bits(lc->bw, 1, 1);
        }
        if (run_count) put_bits(lc->bw, 1, 1);
    }
    lc->run_index = run_index;
    return 0;
}

static void decode_line(LineCtx *lc, int16_t **sample, int w, int bits)
{
    int x, run_count = 0, run_mode = 0, run_index = lc->run_index;

    if (lc->slice_coding_mode == 1) {
        for (x = 0; x < w; x++) {
            int i, v = 0;
            for (i = 0; i < bits; i++) {
                uint8_t st = 128;
                v += v + get_rac(lc->rd, &st);
            }
            sample[1][x] = (int16_t)v;
        }
        return;
    }

    for (x = 0; x < w; x++) {
        int sign, diff;
        int context = get_ctx(lc->qt, sample[1] + x, sample[0] + x,
                              sample[1] + x, lc->five);
        if (context < 0) { context = -context; sign = 1; } else sign = 0;

        if (lc->ac) {
            diff = get_symbol(lc->rd, lc->states + (size_t)context * 32, 1);
        } else {
            if (context == 0 && run_mode == 0) run_mode = 1;
            if (run_mode) {
                if (run_count == 0 && run_mode == 1) {
                    if (get_bit(lc->br)) {
                        run_count = 1 << log2_run[run_index];
                        if (x + run_count <= w) run_index++;
                    } else {
                        if (log2_run[run_index])
                            run_count = (int)get_bits_n(
                                lc->br, log2_run[run_index]);
                        else
                            run_count = 0;
                        if (run_index) run_index--;
                        run_mode = 2;
                    }
                }
                run_count--;
                if (run_count < 0) {
                    run_mode = 0;
                    run_count = 0;
                    diff = get_vlc_symbol(lc->br, lc->vlc + context, bits);
                    if (diff >= 0) diff++;
                } else {
                    diff = 0;
                }
            } else {
                diff = get_vlc_symbol(lc->br, lc->vlc + context, bits);
            }
        }
        if (sign) diff = -diff;
        {
            int pred = mid_pred(sample[1][x - 1],
                                sample[1][x - 1] + sample[0][x] -
                                sample[0][x - 1],
                                sample[0][x]);
            sample[1][x] = (int16_t)((pred + diff) &
                                     ((1 << bits) - 1));
        }
    }
    lc->run_index = run_index;
}

/* ---------------- plane coding (public ABI) ---------------- */

/* rcf layout: [low, range, ocount, obyte]; bw state passed separately */

API int64_t ffv1n_encode_plane(
    const uint8_t *src, int32_t sample_size, int32_t w, int32_t h,
    int64_t stride, int32_t pixel_stride, int32_t bits,
    int32_t packed_at_lsb, int32_t ring_size,
    const int16_t *qt, uint8_t *states, VlcState *vlc,
    const uint8_t *one_tab, const uint8_t *zero_tab,
    int32_t ac, int32_t slice_coding_mode,
    int32_t *rcf, int64_t *rc_pos,
    uint8_t *buf, int64_t buf_cap,
    uint8_t *pb_buf, int64_t pb_cap,
    int64_t *bw_state /* [pos_bits, acc, nacc] */)
{
    int x, y, i;
    int16_t *sbuf = calloc((size_t)ring_size * (w + 6), sizeof(int16_t));
    int16_t *sample[3];
    RcState rs = { rcf[0], rcf[1], rcf[2], rcf[3], *rc_pos };
    RcEnc re = { &rs, buf, buf_cap, one_tab, zero_tab, 0 };
    BitWr bw = { pb_buf, pb_cap, bw_state[0], (uint64_t)bw_state[1],
                 (int)bw_state[2], 0 };
    LineCtx lc = { ac, bits, 0, slice_coding_mode, qt, states, vlc,
                   qt[3 * 256 + 127] != 0, &re, &bw, NULL, NULL };
    int ret = 0;

    if (!sbuf) return -2;
    for (y = 0; y < h && ret == 0; y++) {
        for (i = 0; i < ring_size; i++)
            sample[i] = sbuf + (size_t)(w + 6) *
                ((h + i - y) % ring_size) + 3;
        sample[0][-1] = sample[1][0];
        sample[1][w] = sample[1][w - 1];
        if (sample_size == 1) {
            for (x = 0; x < w; x++)
                sample[0][x] = src[(size_t)x * pixel_stride + stride * y];
        } else if (packed_at_lsb) {
            for (x = 0; x < w; x++)
                sample[0][x] = (int16_t)((const uint16_t *)(src + stride * y))
                    [(size_t)x * pixel_stride];
        } else {
            for (x = 0; x < w; x++)
                sample[0][x] = (int16_t)(((const uint16_t *)(src + stride * y))
                    [(size_t)x * pixel_stride] >> (16 - bits));
        }
        ret = encode_line(&lc, sample, w, bits);
    }
    free(sbuf);
    rcf[0] = rs.low; rcf[1] = rs.range; rcf[2] = rs.ocount;
    rcf[3] = rs.obyte; *rc_pos = rs.pos;
    bw_state[0] = bw.pos_bits; bw_state[1] = (int64_t)bw.acc;
    bw_state[2] = bw.nacc;
    return ret;
}

API int64_t ffv1n_decode_plane(
    uint8_t *dst, int32_t sample_size, int32_t w, int32_t h,
    int64_t stride, int32_t pixel_stride, int32_t bits,
    int32_t packed_at_lsb,
    const int16_t *qt, uint8_t *states, VlcState *vlc,
    const uint8_t *one_tab, const uint8_t *zero_tab,
    int32_t ac, int32_t slice_coding_mode,
    int32_t *rcf, int64_t *rc_pos,
    const uint8_t *buf, int64_t buf_len,
    int64_t *br_pos_bits)
{
    int x, y;
    int16_t *sbuf = calloc(2 * (size_t)(w + 6), sizeof(int16_t));
    int16_t *s0, *s1, *tmp;
    RcState rs = { rcf[0], rcf[1], rcf[2], rcf[3], *rc_pos };
    RcDec rd = { &rs, buf, buf_len, one_tab, zero_tab };
    BitRd br = { buf, buf_len, *br_pos_bits };
    LineCtx lc = { ac, bits, 0, slice_coding_mode, qt, states, vlc,
                   qt[3 * 256 + 127] != 0, NULL, NULL, &rd, &br };

    if (!sbuf) return -2;
    s0 = sbuf + 3;
    s1 = sbuf + (w + 6) + 3;
    for (y = 0; y < h; y++) {
        int16_t *sample[2];
        tmp = s0; s0 = s1; s1 = tmp;
        sample[0] = s0; sample[1] = s1;
        sample[1][-1] = sample[0][0];
        sample[0][w] = sample[0][w - 1];
        decode_line(&lc, sample, w, bits);
        if (sample_size == 1) {
            for (x = 0; x < w; x++)
                dst[(size_t)x * pixel_stride + stride * y] =
                    (uint8_t)sample[1][x];
        } else if (packed_at_lsb) {
            for (x = 0; x < w; x++)
                ((uint16_t *)(dst + stride * y))[(size_t)x * pixel_stride] =
                    (uint16_t)sample[1][x];
        } else {
            for (x = 0; x < w; x++)
                ((uint16_t *)(dst + stride * y))[(size_t)x * pixel_stride] =
                    (uint16_t)((uint32_t)sample[1][x] << (16 - bits));
        }
    }
    free(sbuf);
    rcf[0] = rs.low; rcf[1] = rs.range; rcf[2] = rs.ocount;
    rcf[3] = rs.obyte; *rc_pos = rs.pos;
    *br_pos_bits = br.pos;
    return 0;
}

/* RGB: line-interleaved plane coding (ffv1enc.c:413-473).
 * mode 0: packed BGRA uint8 rows (lbd); mode 1: planar uint16 (gbrp).  */
API int64_t ffv1n_encode_rgb(
    const uint8_t *p0, const uint8_t *p1, const uint8_t *p2,
    int32_t mode, int32_t w, int32_t h, int64_t stride,
    int32_t bits, int32_t transparency, int32_t ring_size,
    const int16_t *qt0, const int16_t *qt1, const int16_t *qt2,
    uint8_t *st0, uint8_t *st1, uint8_t *st2,
    VlcState *vl0, VlcState *vl1, VlcState *vl2,
    const uint8_t *one_tab, const uint8_t *zero_tab,
    int32_t ac, int32_t slice_coding_mode,
    int32_t rct_by, int32_t rct_ry,
    int32_t *rcf, int64_t *rc_pos, uint8_t *buf, int64_t buf_cap,
    uint8_t *pb_buf, int64_t pb_cap,
    int64_t *bw_state)
{
    int x, y, p, i;
    int nplanes = 3 + (transparency ? 1 : 0);
    int offset = 1 << bits;
    int lbd = bits <= 8;
    int16_t *sbuf = calloc((size_t)ring_size * 4 * (w + 6),
                           sizeof(int16_t));
    RcState rs = { rcf[0], rcf[1], rcf[2], rcf[3], *rc_pos };
    RcEnc re = { &rs, buf, buf_cap, one_tab, zero_tab, 0 };
    BitWr bw = { pb_buf, pb_cap, bw_state[0], (uint64_t)bw_state[1],
                 (int)bw_state[2], 0 };
    uint8_t *sts[3] = { st0, st1, st2 };
    VlcState *vls[3] = { vl0, vl1, vl2 };
    const int16_t *qts[3] = { qt0, qt1, qt2 };
    int ret = 0;

    if (!sbuf) return -2;
    for (y = 0; y < h && ret == 0; y++) {
        int16_t *sample[4][3];
        for (i = 0; i < ring_size; i++)
            for (p = 0; p < 4; p++)
                sample[p][i] = sbuf +
                    (size_t)(w + 6) * (p * ring_size +
                                       (h + i - y) % ring_size) + 3;
        for (x = 0; x < w; x++) {
            int b, g, r, a = 0;
            if (mode == 0) {
                const uint8_t *px = p0 + (size_t)x * 4 + stride * y;
                b = px[0]; g = px[1]; r = px[2]; a = px[3];
            } else {
                b = ((const uint16_t *)(p0 + stride * y))[x];
                g = ((const uint16_t *)(p1 + stride * y))[x];
                r = ((const uint16_t *)(p2 + stride * y))[x];
            }
            if (slice_coding_mode != 1) {
                b -= g;
                r -= g;
                g += (b * rct_by + r * rct_ry) >> 2;
                b += offset;
                r += offset;
            }
            sample[0][0][x] = (int16_t)g;
            sample[1][0][x] = (int16_t)b;
            sample[2][0][x] = (int16_t)r;
            sample[3][0][x] = (int16_t)a;
        }
        for (p = 0; p < nplanes && ret == 0; p++) {
            int ci = (p + 1) / 2;
            LineCtx lc = { ac, bits, 0, slice_coding_mode, qts[ci],
                           sts[ci], vls[ci],
                           qts[ci][3 * 256 + 127] != 0, &re, &bw,
                           NULL, NULL };
            /* run_index is shared across the whole RGB slice */
            lc.run_index = (int)bw_state[3];
            sample[p][0][-1] = sample[p][1][0];
            sample[p][1][w] = sample[p][1][w - 1];
            if (lbd && slice_coding_mode == 0)
                ret = encode_line(&lc, sample[p], w, 9);
            else
                ret = encode_line(&lc, sample[p], w,
                                  bits + (slice_coding_mode != 1));
            bw_state[3] = lc.run_index;
        }
    }
    free(sbuf);
    rcf[0] = rs.low; rcf[1] = rs.range; rcf[2] = rs.ocount;
    rcf[3] = rs.obyte; *rc_pos = rs.pos;
    bw_state[0] = bw.pos_bits; bw_state[1] = (int64_t)bw.acc;
    bw_state[2] = bw.nacc;
    return ret;
}

API int64_t ffv1n_decode_rgb(
    uint8_t *p0, uint8_t *p1, uint8_t *p2,
    int32_t mode, int32_t w, int32_t h, int64_t stride,
    int32_t bits, int32_t transparency,
    const int16_t *qt0, const int16_t *qt1, const int16_t *qt2,
    uint8_t *st0, uint8_t *st1, uint8_t *st2,
    VlcState *vl0, VlcState *vl1, VlcState *vl2,
    const uint8_t *one_tab, const uint8_t *zero_tab,
    int32_t ac, int32_t slice_coding_mode,
    int32_t rct_by, int32_t rct_ry,
    int32_t *rcf, int64_t *rc_pos, const uint8_t *buf, int64_t buf_len,
    int64_t *br_state /* [pos_bits, run_index] */)
{
    int x, y, p;
    int nplanes = 3 + (transparency ? 1 : 0);
    int offset = 1 << bits;
    int lbd = bits <= 8;
    int16_t *sbuf = calloc(8 * (size_t)(w + 6), sizeof(int16_t));
    int16_t *rows[4][2];
    RcState rs = { rcf[0], rcf[1], rcf[2], rcf[3], *rc_pos };
    RcDec rd = { &rs, buf, buf_len, one_tab, zero_tab };
    BitRd br = { buf, buf_len, br_state[0] };
    uint8_t *sts[3] = { st0, st1, st2 };
    VlcState *vls[3] = { vl0, vl1, vl2 };
    const int16_t *qts[3] = { qt0, qt1, qt2 };

    if (!sbuf) return -2;
    for (p = 0; p < 4; p++) {
        rows[p][0] = sbuf + (size_t)(p * 2) * (w + 6) + 3;
        rows[p][1] = sbuf + (size_t)(p * 2 + 1) * (w + 6) + 3;
    }
    for (y = 0; y < h; y++) {
        for (p = 0; p < nplanes; p++) {
            int ci = (p + 1) / 2;
            int16_t *tmp = rows[p][0];
            int16_t *sample[2];
            LineCtx lc = { ac, bits, 0, slice_coding_mode, qts[ci],
                           sts[ci], vls[ci],
                           qts[ci][3 * 256 + 127] != 0, NULL, NULL,
                           &rd, &br };
            lc.run_index = (int)br_state[1];
            rows[p][0] = rows[p][1];
            rows[p][1] = tmp;
            sample[0] = rows[p][0];
            sample[1] = rows[p][1];
            sample[1][-1] = sample[0][0];
            sample[0][w] = sample[0][w - 1];
            if (lbd && slice_coding_mode == 0)
                decode_line(&lc, sample, w, 9);
            else
                decode_line(&lc, sample, w,
                            bits + (slice_coding_mode != 1));
            br_state[1] = lc.run_index;
        }
        for (x = 0; x < w; x++) {
            int g = rows[0][1][x];
            int b = rows[1][1][x];
            int r = rows[2][1][x];
            int a = rows[3][1][x];
            if (slice_coding_mode != 1) {
                b -= offset;
                r -= offset;
                g -= (b * rct_by + r * rct_ry) >> 2;
                b += g;
                r += g;
            }
            if (mode == 0) {
                uint32_t word = (uint32_t)((b & 0xFF) | ((g & 0xFF) << 8) |
                                           ((r & 0xFF) << 16) |
                                           ((a & 0xFF) << 24));
                uint8_t *px = p0 + (size_t)x * 4 + stride * y;
                px[0] = word & 0xFF;
                px[1] = (word >> 8) & 0xFF;
                px[2] = (word >> 16) & 0xFF;
                px[3] = (word >> 24) & 0xFF;
            } else {
                ((uint16_t *)(p0 + stride * y))[x] = (uint16_t)b;
                ((uint16_t *)(p1 + stride * y))[x] = (uint16_t)g;
                ((uint16_t *)(p2 + stride * y))[x] = (uint16_t)r;
            }
        }
    }
    free(sbuf);
    rcf[0] = rs.low; rcf[1] = rs.range; rcf[2] = rs.ocount;
    rcf[3] = rs.obyte; *rc_pos = rs.pos;
    br_state[0] = br.pos;
    return 0;
}

/* ---------------- CRC-32 (IEEE poly, av_crc bit order) ---------------- */

static uint32_t crc_tab[8][256];   /* slice-by-8 (av_crc's CRC_TABLE_SIZE
                                      "large table" variant, crc.c:303) */
static int crc_init_done;

static void crc_init(void)
{
    int i, j, k;
    for (i = 0; i < 256; i++) {
        uint32_t c = (uint32_t)i << 24;
        for (j = 0; j < 8; j++)
            c = (c << 1) ^ (0x04C11DB7u & (uint32_t)(-(int32_t)(c >> 31)));
        crc_tab[0][i] = __builtin_bswap32(c);
    }
    for (k = 1; k < 8; k++)
        for (i = 0; i < 256; i++)
            crc_tab[k][i] = crc_tab[0][crc_tab[k - 1][i] & 0xFF] ^
                            (crc_tab[k - 1][i] >> 8);
    crc_init_done = 1;
}

API uint32_t ffv1n_crc32(const uint8_t *buf, int64_t len, uint32_t crc)
{
    if (!crc_init_done) crc_init();
    /* align, then consume 8 bytes per round: two 32-bit word fetches
       folded through the 8 stride tables (same result as the byte
       loop; ~6-8x the throughput on the per-slice CRC checks) */
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    while (len > 0 && ((uintptr_t)buf & 7)) {
        crc = crc_tab[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
        len--;
    }
    while (len >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, buf, 4);
        memcpy(&hi, buf + 4, 4);
        lo ^= crc;
        crc = crc_tab[7][lo & 0xFF] ^
              crc_tab[6][(lo >> 8) & 0xFF] ^
              crc_tab[5][(lo >> 16) & 0xFF] ^
              crc_tab[4][lo >> 24] ^
              crc_tab[3][hi & 0xFF] ^
              crc_tab[2][(hi >> 8) & 0xFF] ^
              crc_tab[1][(hi >> 16) & 0xFF] ^
              crc_tab[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
#endif
    while (len-- > 0)
        crc = crc_tab[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
    return crc;
}

/* ------------- two-pass initial-state DP (exact FP parity) -------------
 * Semantics of ffv1enc.c:139-183 (find_best_state): a dynamic program
 * over adaptive-state evolution under a fixed one-bit probability p.
 * The FP accumulation order is observable in the chosen states, so this
 * runs as the same scalar double fold (a vectorized evaluation rounds
 * differently on ulp ties); kept in the native tier next to the other
 * speed-critical host loops. */

API void ffv1n_find_best_state(const uint8_t *one_state,
                               uint8_t *best_state /* [256*256] */)
{
    double l2tab[256];
    int i;

    for (i = 1; i < 256; i++)
        l2tab[i] = log2(i / 256.0);

    for (i = 0; i < 256; i++) {
        double best_len[256];
        const double p = i / 256.0;
        int j, k, m;

        for (j = 0; j < 256; j++)
            best_len[j] = 1 << 30;

        for (j = i - 10 > 1 ? i - 10 : 1;
             j < (i + 11 < 256 ? i + 11 : 256); j++) {
            double occ[256] = { 0 };
            double len = 0;

            if (!one_state[j])
                continue;
            occ[j] = 1.0;

            for (k = 0; k < 256; k++) {
                double nocc[256] = { 0 };
                for (m = 1; m < 256; m++)
                    if (occ[m])
                        len -= occ[m] * (p * l2tab[m] +
                                         (1 - p) * l2tab[256 - m]);
                if (len < best_len[k]) {
                    best_len[k] = len;
                    best_state[256 * i + k] = (uint8_t)j;
                }
                for (m = 1; m < 256; m++)
                    if (occ[m]) {
                        nocc[one_state[m]] += occ[m] * p;
                        nocc[256 - one_state[256 - m]] += occ[m] * (1 - p);
                    }
                memcpy(occ, nocc, sizeof(occ));
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* Segment-copy compaction for the device encoder's host-compact finalize
 * (tpu/rc_scan_lanes.py finalize_packed_hostcompact).  The device
 * emits, per lane, carry-resolved byte sections [prefix pcap | group
 * slots NG*C | tail 3] plus per-group valid counts; this walks the
 * segments and memcpy-packs the valid bytes — the host-side
 * replacement for the device sort network.  Copies exactly `count`
 * bytes per lane (the last provisional byte never flushes, so the
 * caller passes total-1). */
API void ffv1n_compact_groups(
    const uint8_t *resolved,    /* L x rstride: [prefix|data|tail]    */
    int64_t rstride,
    const uint8_t *gcounts,     /* L x ng: valid bytes per group      */
    int64_t gstride,
    const int32_t *plens,       /* per-lane prefix byte counts        */
    const int64_t *counts,      /* per-lane total output bytes        */
    int32_t lanes, int32_t pcap, int32_t ng, int32_t groupc,
    uint8_t *out, int64_t ostride)
{
    for (int32_t l = 0; l < lanes; l++) {
        const uint8_t *src = resolved + (int64_t)l * rstride;
        const uint8_t *gc  = gcounts + (int64_t)l * gstride;
        uint8_t *dst = out + (int64_t)l * ostride;
        int64_t want = counts[l];
        int64_t off = 0;
        int32_t pl = plens[l];
        if (pl > want) pl = (int32_t)want;
        memcpy(dst, src, pl);
        off = pl;
        const uint8_t *data = src + pcap;
        for (int32_t g = 0; g < ng && off < want; g++) {
            int32_t n = gc[g];
            if (n > groupc) n = groupc;
            if (off + n > want) n = (int32_t)(want - off);
            memcpy(dst + off, data + (int64_t)g * groupc, n);
            off += n;
        }
        const uint8_t *tail = src + pcap + (int64_t)ng * groupc;
        for (int32_t t = 0; t < 3 && off < want; t++)
            dst[off++] = tail[t];
    }
}
