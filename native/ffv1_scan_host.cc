/* Host build of the per-lane scans of ffv1_scan.h: the same routines
 * the CUDA kernels run, looped over lanes, so the CPU tests check the
 * kernels' arithmetic against the XLA lane scans.  Build: make -C native
 * scan-host.  Array layouts are those of the FFI handlers in
 * ffv1_cuda.cu. */
#include <string.h>

#include "ffv1_scan.h"

#define API extern "C" __attribute__((visibility("default")))

API void ffv1s_encode(const int32_t *ctx, const int32_t *diff,
                      const uint8_t *act, int64_t L, int64_t N,
                      const uint8_t *states0, int64_t CC,
                      const uint8_t *one, const uint8_t *zero,
                      const int32_t *low0, const int32_t *rng0,
                      int32_t bits, int32_t *packed, int32_t *low,
                      int32_t *rng, uint8_t *states)
{
    const int S = ffv1_slot_count(bits);
    memset(packed, 0, (size_t)N * S * L * sizeof(int32_t));
    memcpy(states, states0, (size_t)L * CC * 32);
    for (int64_t l = 0; l < L; l++) {
        int lo = low0[l], ra = rng0[l];
        ffv1_encode_lane(ctx + l * N, diff + l * N, act + l * N, N,
                         states + l * CC * 32, bits, &lo, &ra, one, zero,
                         packed + l, L);
        low[l] = lo;
        rng[l] = ra;
    }
}

API void ffv1s_decode(const uint8_t *bufs, int64_t L, int64_t cap,
                      const uint8_t *states0, int64_t CC,
                      const uint8_t *one, const uint8_t *zero,
                      const int32_t *qt, const int32_t *low0,
                      const int32_t *rng0, const int32_t *pos0,
                      const int32_t *specs, int32_t nplanes, int32_t bits,
                      int32_t five, int32_t *out, int64_t total,
                      uint8_t *states, int32_t *low, int32_t *rng,
                      int32_t *pos)
{
    int wmax = 1;
    for (int p = 0; p < nplanes; p++)
        wmax = specs[3 * p] > wmax ? specs[3 * p] : wmax;
    int32_t *ring = new int32_t[2 * (wmax + 6)];
    memcpy(states, states0, (size_t)L * CC * 32);
    for (int64_t l = 0; l < L; l++) {
        Ffv1Dec d = {low0[l], rng0[l], pos0[l], bufs + l * cap, (int)cap,
                     one, zero};
        ffv1_decode_lane(&d, states + l * CC * 32, specs, nplanes, qt, five,
                         bits, ring, out + l * total);
        low[l] = d.low;
        rng[l] = d.rng;
        pos[l] = d.pos;
    }
    delete[] ring;
}
