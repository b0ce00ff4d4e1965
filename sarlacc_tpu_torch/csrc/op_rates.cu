// Per-instruction-class rates of the card, for the instruction mix of the
// score-only DP and of a warp-split DP.  Two families of kernels, one C
// entry per class:
//
// * op_mix (sarlacc_op_mix_*) replaces scripts/microbench_op_mix.py's
//   kernel (its _launch, inner kern :43, pallas_call :59): one DEPENDENT
//   chain per thread, DEPTH = 16 steps per iteration, each step depending
//   on the last and alternating operand registers, with the iteration's
//   constant add folded in first.  Measures an op class's rate when every
//   op waits for the previous one, as in a DP recurrence;
// * op_rates (sarlacc_op_rates_*) replaces scripts/microbench_vpu_ops.py's
//   _bench_kernel (pallas_call :67): CHAINS = 4 INDEPENDENT chains of
//   DEPTH = 8 per iteration, for throughput.
//
// Plain PyTorch versions: sarlacc_tpu_torch/tools/op_rates.py::
// op_rates_plain and tools/op_mix.py::op_mix_plain, which give the same
// bits at any iteration count.
//
// The TPU's sublane roll (pltpu.roll) becomes __shfl_up_sync across the 32
// lanes of a warp: lanes below the shift keep their own value (the shuffle's
// rule), and the shift stage masks them to NEG as the DP's prefix max does.
// The grid fills every SM (the wrapper sizes it from the SM count): a rate
// measured on one SM is not the card's.
//
// Folding: every chain runs through ``iters`` (a runtime count, the loop not
// unrolled) and is written out; operands alternate between two registers
// that the compiler cannot prove equal (two loads, two runtime lane limits),
// so idempotent patterns (max(max(x, b), b), nested selects on one
// predicate) cannot collapse.  tools/op_rates.py::sass_census counts each
// class's instructions in the built library to confirm it.  No volatile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int MIX_DEPTH = 16;
constexpr int RATE_CHAINS = 4;
constexpr int RATE_DEPTH = 8;

enum Mix { ELEMENTWISE, SELECT_ADD, SHIFT_MAX, SHIFT_STAGE };
enum Rate { ADD, MAX, SELECT, SHFL1, SHFL16 };

template <int CLS>
__global__ void op_mix_kernel(
    const float* __restrict__ a, const float* __restrict__ b1,
    const float* __restrict__ b2, float* __restrict__ out, int iters)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const float p = b1[t];
    const float q = b2[t];
    float x = a[t];
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
        x = x + 1e-7f;
#pragma unroll
        for (int s = 0; s < MIX_DEPTH; ++s) {
            const float b = (s & 1) ? p : q;
            if (CLS == ELEMENTWISE) {
                x = fmaxf(x + b, q);
            } else if (CLS == SELECT_ADD) {
                x = (lane < (1 << (s & 3)) ? b : x) + 1e-7f;
            } else if (CLS == SHIFT_MAX) {
                x = fmaxf(__shfl_up_sync(FULL, x, 1 + s % 3), b);
            } else {
                const int sh = 1 << (s % 5);
                const float r = __shfl_up_sync(FULL, x, sh);
                x = fmaxf(lane < sh ? NEG : r, b);
            }
        }
    }
    out[t] = x;
}

template <int CLS>
__device__ __forceinline__ float rate_step(float x, float b, bool m)
{
    if (CLS == ADD) return x + b;
    if (CLS == MAX) return fmaxf(x, b);
    if (CLS == SELECT) return m ? b : x;
    if (CLS == SHFL1) return __shfl_up_sync(FULL, x, 1) + b;
    return __shfl_up_sync(FULL, x, 16) + b;
}

template <int CLS>
__global__ void op_rates_kernel(
    const float* __restrict__ a, const float* __restrict__ b1,
    const float* __restrict__ b2, float* __restrict__ out, int iters,
    int k1, int k2)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const float p = b1[t];
    const float q = b2[t];
    const bool m1 = lane < k1;
    const bool m2 = lane < k2;
    float x[RATE_CHAINS];
#pragma unroll
    for (int c = 0; c < RATE_CHAINS; ++c) x[c] = a[t] + (float)c;
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int d = 0; d < RATE_DEPTH; ++d) {
#pragma unroll
            for (int c = 0; c < RATE_CHAINS; ++c) {
                x[c] = rate_step<CLS>(x[c], (d & 1) ? q : p, (d & 1) ? m2 : m1);
            }
        }
    }
    out[t] = ((x[0] + x[1]) + x[2]) + x[3];
}

}  // namespace

// Every entry launches ``blocks`` blocks of 256 threads over arrays of
// blocks * 256 floats and returns cudaGetLastError().
#define SARLACC_MIX_ENTRY(NAME, CLS)                                           \
    extern "C" int NAME(const float* a, const float* b1, const float* b2,     \
                        float* out, int iters, int blocks, void* stream)      \
    {                                                                          \
        if (blocks <= 0) return 0;                                             \
        op_mix_kernel<CLS><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(      \
            a, b1, b2, out, iters);                                            \
        return (int)cudaGetLastError();                                        \
    }

#define SARLACC_RATE_ENTRY(NAME, CLS)                                          \
    extern "C" int NAME(const float* a, const float* b1, const float* b2,     \
                        float* out, int iters, int k1, int k2, int blocks,    \
                        void* stream)                                          \
    {                                                                          \
        if (blocks <= 0) return 0;                                             \
        op_rates_kernel<CLS><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(    \
            a, b1, b2, out, iters, k1, k2);                                    \
        return (int)cudaGetLastError();                                        \
    }

SARLACC_MIX_ENTRY(sarlacc_op_mix_elementwise, ELEMENTWISE)
SARLACC_MIX_ENTRY(sarlacc_op_mix_select_add, SELECT_ADD)
SARLACC_MIX_ENTRY(sarlacc_op_mix_shift_max, SHIFT_MAX)
SARLACC_MIX_ENTRY(sarlacc_op_mix_shift_stage, SHIFT_STAGE)

SARLACC_RATE_ENTRY(sarlacc_op_rates_add, ADD)
SARLACC_RATE_ENTRY(sarlacc_op_rates_max, MAX)
SARLACC_RATE_ENTRY(sarlacc_op_rates_select, SELECT)
SARLACC_RATE_ENTRY(sarlacc_op_rates_shfl1, SHFL1)
SARLACC_RATE_ENTRY(sarlacc_op_rates_shfl16, SHFL16)
