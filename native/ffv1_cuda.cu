// CUDA range-coder scans for the GPU path, called from JAX through its
// foreign function interface (tpu_ffv1/tpu/cuda_scan.py).
//
// Each lane (one slice bitstream) is a serial integer state machine, so
// a block owns one lane and its first thread runs the lane's whole scan
// (ffv1_scan.h) in one launch; the block's warp only stages the lane's
// context table into shared memory and writes it back.  Tables that do
// not fit in a block's shared memory (context model 1) stay in device
// memory, updated in place in the output.
//
// Build: make -C native cuda   (nvcc, sm_90a, into build/)

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "ffv1_scan.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 32;
constexpr size_t kSmemMax = 227 * 1024;  // per-block limit on sm_90

__device__ void copy16(void *dst, const void *src, int64_t nbytes)
{
    uint4 *d = static_cast<uint4 *>(dst);
    const uint4 *s = static_cast<const uint4 *>(src);
    for (int64_t i = threadIdx.x; i < nbytes / 16; i += blockDim.x)
        d[i] = s[i];
}

__host__ __device__ constexpr size_t align16(size_t n)
{
    return (n + 15) & ~size_t(15);
}

template <bool kSmemStates>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const int32_t *ctx, const int32_t *diff, const uint8_t *act,
              int64_t L, int64_t N, const uint8_t *states0, int64_t CC,
              const uint8_t *one, const uint8_t *zero, const int32_t *low0,
              const int32_t *rng0, int bits, int32_t *packed, int32_t *low,
              int32_t *rng, uint8_t *states)
{
    extern __shared__ __align__(16) uint8_t smem[];
    const int64_t l = blockIdx.x;
    const int64_t sb = CC * 32;
    uint8_t *tabs = smem;
    uint8_t *st = kSmemStates ? smem + 512 : states + l * sb;
    copy16(tabs, one, 256);
    copy16(tabs + 256, zero, 256);
    copy16(st, states0 + l * sb, sb);
    __syncthreads();
    if (threadIdx.x == 0) {
        int lo = low0[l], ra = rng0[l];
        ffv1_encode_lane(ctx + l * N, diff + l * N, act + l * N, N, st, bits,
                         &lo, &ra, tabs, tabs + 256, packed + l, L);
        low[l] = lo;
        rng[l] = ra;
    }
    __syncthreads();
    if (kSmemStates)
        copy16(states + l * sb, st, sb);
}

template <bool kSmemStates>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint8_t *bufs, int64_t cap, const uint8_t *states0,
              int64_t CC, const uint8_t *one, const uint8_t *zero,
              const int32_t *qt, const int32_t *low0, const int32_t *rng0,
              const int32_t *pos0, const int32_t *specs, int nplanes,
              int bits, int five, int wmax, int32_t *out, int64_t total,
              uint8_t *states, int32_t *low, int32_t *rng, int32_t *pos)
{
    extern __shared__ __align__(16) uint8_t smem[];
    const int64_t l = blockIdx.x;
    const int64_t sb = CC * 32;
    int32_t *qts = reinterpret_cast<int32_t *>(smem);           // 5 x 256
    int32_t *ring = qts + 5 * 256;                              // 2 rows
    uint8_t *tabs = smem + 5 * 1024 + align16(8 * (size_t)(wmax + 6));
    uint8_t *st = kSmemStates ? tabs + 512 : states + l * sb;
    copy16(qts, qt, 5 * 1024);
    copy16(tabs, one, 256);
    copy16(tabs + 256, zero, 256);
    copy16(st, states0 + l * sb, sb);
    __syncthreads();
    if (threadIdx.x == 0) {
        Ffv1Dec d = {low0[l], rng0[l], pos0[l], bufs + l * cap, (int)cap,
                     tabs, tabs + 256};
        ffv1_decode_lane(&d, st, specs, nplanes, qts, five, bits, ring,
                         out + l * total);
        low[l] = d.low;
        rng[l] = d.rng;
        pos[l] = d.pos;
    }
    __syncthreads();
    if (kSmemStates)
        copy16(states + l * sb, st, sb);
}

template <typename Kernel>
cudaError_t launch_setup(Kernel kernel, size_t smem)
{
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

ffi::Error status(const char *what)
{
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess)
        return ffi::Error::Internal(std::string(what) + ": " +
                                    cudaGetErrorString(err));
    return ffi::Error::Success();
}

ffi::Error EncodeImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> ctx,
                      ffi::Buffer<ffi::S32> diff, ffi::Buffer<ffi::U8> act,
                      ffi::Buffer<ffi::U8> states0, ffi::Buffer<ffi::U8> one,
                      ffi::Buffer<ffi::U8> zero, ffi::Buffer<ffi::S32> low0,
                      ffi::Buffer<ffi::S32> rng0, int32_t bits,
                      ffi::ResultBuffer<ffi::S32> packed,
                      ffi::ResultBuffer<ffi::S32> low,
                      ffi::ResultBuffer<ffi::S32> rng,
                      ffi::ResultBuffer<ffi::U8> states)
{
    auto cd = ctx.dimensions();
    auto sd = states0.dimensions();
    if (cd.size() != 2 || sd.size() != 3 || sd[2] != 32)
        return ffi::Error::InvalidArgument("ffv1_rc_encode: bad shapes");
    if (bits < 1 || bits > 17)
        return ffi::Error::InvalidArgument("ffv1_rc_encode: bits");
    const int64_t L = cd[0], N = cd[1], CC = sd[1];
    if (L == 0)
        return ffi::Error::Success();
    cudaMemsetAsync(packed->typed_data(), 0, packed->size_bytes(), stream);
    const size_t smem = 512 + CC * 32;
    if (smem <= kSmemMax) {
        launch_setup(encode_kernel<true>, smem);
        encode_kernel<true><<<L, kThreads, smem, stream>>>(
            ctx.typed_data(), diff.typed_data(), act.typed_data(), L, N,
            states0.typed_data(), CC, one.typed_data(), zero.typed_data(),
            low0.typed_data(), rng0.typed_data(), bits, packed->typed_data(),
            low->typed_data(), rng->typed_data(), states->typed_data());
    } else {
        encode_kernel<false><<<L, kThreads, 512, stream>>>(
            ctx.typed_data(), diff.typed_data(), act.typed_data(), L, N,
            states0.typed_data(), CC, one.typed_data(), zero.typed_data(),
            low0.typed_data(), rng0.typed_data(), bits, packed->typed_data(),
            low->typed_data(), rng->typed_data(), states->typed_data());
    }
    return status("ffv1_rc_encode");
}

ffi::Error DecodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> bufs,
                      ffi::Buffer<ffi::U8> states0, ffi::Buffer<ffi::U8> one,
                      ffi::Buffer<ffi::U8> zero, ffi::Buffer<ffi::S32> qt,
                      ffi::Buffer<ffi::S32> low0, ffi::Buffer<ffi::S32> rng0,
                      ffi::Buffer<ffi::S32> pos0, ffi::Buffer<ffi::S32> specs,
                      int32_t bits, int32_t five, int32_t wmax,
                      ffi::ResultBuffer<ffi::S32> out,
                      ffi::ResultBuffer<ffi::U8> states,
                      ffi::ResultBuffer<ffi::S32> low,
                      ffi::ResultBuffer<ffi::S32> rng,
                      ffi::ResultBuffer<ffi::S32> pos)
{
    auto bd = bufs.dimensions();
    auto sd = states0.dimensions();
    auto od = out->dimensions();
    if (bd.size() != 2 || sd.size() != 3 || sd[2] != 32 || od.size() != 2 ||
        qt.element_count() != 5 * 256 || specs.element_count() % 3)
        return ffi::Error::InvalidArgument("ffv1_rc_decode: bad shapes");
    if (bits < 1 || bits > 17 || wmax < 1)
        return ffi::Error::InvalidArgument("ffv1_rc_decode: bits/wmax");
    const int64_t L = bd[0], cap = bd[1], CC = sd[1], total = od[1];
    const int nplanes = (int)(specs.element_count() / 3);
    if (L == 0)
        return ffi::Error::Success();
    const size_t base = 5 * 1024 + align16(8 * (size_t)(wmax + 6)) + 512;
    const size_t smem = base + CC * 32;
    if (smem <= kSmemMax) {
        launch_setup(decode_kernel<true>, smem);
        decode_kernel<true><<<L, kThreads, smem, stream>>>(
            bufs.typed_data(), cap, states0.typed_data(), CC,
            one.typed_data(), zero.typed_data(), qt.typed_data(),
            low0.typed_data(), rng0.typed_data(), pos0.typed_data(),
            specs.typed_data(), nplanes, bits, five, wmax,
            out->typed_data(), total, states->typed_data(),
            low->typed_data(), rng->typed_data(), pos->typed_data());
    } else {
        if (base > kSmemMax)
            return ffi::Error::InvalidArgument("ffv1_rc_decode: row too wide");
        launch_setup(decode_kernel<false>, base);
        decode_kernel<false><<<L, kThreads, base, stream>>>(
            bufs.typed_data(), cap, states0.typed_data(), CC,
            one.typed_data(), zero.typed_data(), qt.typed_data(),
            low0.typed_data(), rng0.typed_data(), pos0.typed_data(),
            specs.typed_data(), nplanes, bits, five, wmax,
            out->typed_data(), total, states->typed_data(),
            low->typed_data(), rng->typed_data(), pos->typed_data());
    }
    return status("ffv1_rc_decode");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    Ffv1RcEncode, EncodeImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()   // ctx (L, N)
        .Arg<ffi::Buffer<ffi::S32>>()   // diff (L, N)
        .Arg<ffi::Buffer<ffi::U8>>()    // active (L, N)
        .Arg<ffi::Buffer<ffi::U8>>()    // states0 (L, CC, 32)
        .Arg<ffi::Buffer<ffi::U8>>()    // one_tab (256,)
        .Arg<ffi::Buffer<ffi::U8>>()    // zero_tab (256,)
        .Arg<ffi::Buffer<ffi::S32>>()   // low0 (L,)
        .Arg<ffi::Buffer<ffi::S32>>()   // range0 (L,)
        .Attr<int32_t>("bits")
        .Ret<ffi::Buffer<ffi::S32>>()   // packed (N, S, L)
        .Ret<ffi::Buffer<ffi::S32>>()   // low (L,)
        .Ret<ffi::Buffer<ffi::S32>>()   // range (L,)
        .Ret<ffi::Buffer<ffi::U8>>());  // states (L, CC, 32)

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    Ffv1RcDecode, DecodeImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()    // bufs (L, cap)
        .Arg<ffi::Buffer<ffi::U8>>()    // states0 (L, CC, 32)
        .Arg<ffi::Buffer<ffi::U8>>()    // one_tab
        .Arg<ffi::Buffer<ffi::U8>>()    // zero_tab
        .Arg<ffi::Buffer<ffi::S32>>()   // qt (5, 256)
        .Arg<ffi::Buffer<ffi::S32>>()   // low0
        .Arg<ffi::Buffer<ffi::S32>>()   // range0
        .Arg<ffi::Buffer<ffi::S32>>()   // pos0
        .Arg<ffi::Buffer<ffi::S32>>()   // plane specs (P * 3)
        .Attr<int32_t>("bits")
        .Attr<int32_t>("five")
        .Attr<int32_t>("wmax")
        .Ret<ffi::Buffer<ffi::S32>>()   // planes (L, sum of w * h)
        .Ret<ffi::Buffer<ffi::U8>>()    // states
        .Ret<ffi::Buffer<ffi::S32>>()   // low
        .Ret<ffi::Buffer<ffi::S32>>()   // range
        .Ret<ffi::Buffer<ffi::S32>>()); // pos
