// Kernel E: the MSA's profile-merge DP and its walk, in one launch.
//
// Replaces sarlacc_tpu/ops/msa.py::_merge_dp_walk, which is
// ::_profile_merge_kernel (a lax.scan over the DP rows) then
// ::_merge_walk_kernel (a lax.scan over them back).  Plain PyTorch
// versions: sarlacc_tpu_torch/ops/msa.py::_profile_merge_kernel and
// ::_merge_walk_kernel; jmat is bit-identical.
//
// A wave holds Pp merges of one (rows, W) bucket: cost [Pp, rows, W]
// float32 (cost[p, i-1, k] scores profile-A column i against profile-B
// column j = i + lo + k), la, lb, lo, kmax [Pp].  Per merge the gapless
// maximal-weight-trace DP
//   row 0:  S[k] = 0 where lo + k >= 0 and k <= kmax, else NEG;
//   row i:  M = S + (cost if 1 <= j <= lb else NEG)   (one float add)
//           S_up[k] = S[k + 1] (NEG at k = W - 1)
//           Sn = running max over k of max(M, S_up), over ALL W cells,
//                then NEG outside valid (0 <= j <= lb, k <= kmax)
//           choice = 0 if M >= Sn, else 2 if S_up >= Sn, else 1
// writes one choice byte a cell into a [rows, Pp, W] int8 scratch, for
// every cell of rows 1..min(la, rows): the walk's clamped lookups may read
// cells outside the band.  Rows past la (S is frozen there) and padded
// merges (la = 0) do no work; the walk never reads them.  Then the walk:
// from row min(la, rows) down, at each row the first cell kf <= k (k
// clamped into [0, W - 1]) whose choice is not 1, found by a __ballot_sync
// over 32 cells at a time scanning downward; kf <= kz (j = 0) or kf < 0
// ends the walk; choice 0 writes jmat[r - 1, p] = r + lo + kf (the wrapper
// zero-fills jmat) and moves to kf, choice 2 to kf + 1.
//
// Two routes, chosen by W in the wrapper (ops/cuda_walk.py::merge_route):
//
// Warp route (W 32-512, every bucket of the pipeline's usual bandwidth):
// one warp a merge, four merges a block, IT = W / 32 consecutive cells a
// lane in registers, as kernel B's warp route (csrc/pair_kernel.cu).  Per
// row a lane takes S at its last cell + 1 from lane + 1 (__shfl_down_sync),
// keeps a running max of max(M, S_up) over its cells, and a 5-step warp
// scan (exclusive by one more shuffle) completes the row's running max;
// its IT choice bytes go out as one vector store, and the next row's costs
// are loaded while this row computes.  The same warp then walks.
//
// Block route (W above 512, no upper limit: a profile's columns are not
// capped, so a merge of a long profile with a short one can give a band
// of 131 072 cells over a few rows): one block of 256 threads a merge, the
// row's cells in chunks of one cell a thread; S of the previous row and of
// this one in the merge's [2, W] slice of a float32 device scratch; a
// chunk's running max is a warp scan plus the earlier warps' maxima from
// shared memory (double-buffered by chunk, one barrier a chunk and one a
// row) plus the carry from the chunks before.  Warp 0 walks after a block
// barrier.
//
// What bounds it: the DP's chain of rows, each a shuffle scan deep, and
// the walk's chain of about la dependent loads (a row's address depends on
// the column the row above resolved), both per merge; a wave's merges run
// in parallel, and a wave holds tens to a few thousand.  Compulsory
// traffic: the live rows' cost cells once and jmat; ~6 float operations a
// live cell (one add, two max, two compares, a select).
//
// Exactness: max is exact, so the scan's order does not change any bit,
// and the only arithmetic is the one add of M.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1.0e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_BLOCK = 128;  // four merges a block on the warp route
constexpr int BLOCK_THREADS = 256;  // most threads a block on the block route

__device__ __forceinline__ int clamp_k(int k, int W)
{
    return k < 0 ? 0 : (k > W - 1 ? W - 1 : k);
}

// First k' <= c (0 <= c < W) whose choice is not 1 (the end of the
// horizontal run through c), or -1: 32 cells a step, lane l testing cell
// base - l.
__device__ __forceinline__ int run_end(const int8_t* row, int c, int lane)
{
    for (int base = c; base >= 0; base -= 32) {
        const int idx = base - lane;
        const bool hit = idx >= 0 && row[idx] != 1;
        const unsigned m = __ballot_sync(FULL, hit);
        if (m) return base - (__ffs(m) - 1);
    }
    return -1;
}

// One merge's walk by one whole warp over its choice bytes.  ``choices``
// is written earlier in the same launch, so it must not be read through
// the non-coherent read-only path (no const __restrict__ here).
__device__ void merge_walk(const int8_t* choices, int Pp, int rows, int W,
                           int p, int la, int lb, int lo, int lane,
                           int32_t* __restrict__ jmat)
{
    int k = 0;
    for (int r = la < rows ? la : rows; r >= 1; --r) {
        if (r == la) k = lb - la - lo;
        if (r + lo + k <= 0 || lb <= 0) break;  // inactive now and below
        const int8_t* row = choices + ((size_t)(r - 1) * Pp + p) * W;
        const int kf = run_end(row, clamp_k(k, W), lane);
        if (kf <= -(r + lo) || kf < 0) break;  // died
        const int ch = row[kf];
        if (ch == 0) {
            if (lane == 0) jmat[(size_t)(r - 1) * Pp + p] = r + lo + kf;
            k = kf;
        } else if (ch == 2) {
            k = kf + 1;
        }
    }
}

template <int IT>
__device__ __forceinline__ void load_costs(const float* __restrict__ src, float (&c)[IT])
{
    if constexpr (IT % 4 == 0) {
#pragma unroll
        for (int u = 0; u < IT; u += 4) {
            const float4 v = *reinterpret_cast<const float4*>(src + u);
            c[u] = v.x; c[u + 1] = v.y; c[u + 2] = v.z; c[u + 3] = v.w;
        }
    } else if constexpr (IT == 2) {
        const float2 v = *reinterpret_cast<const float2*>(src);
        c[0] = v.x; c[1] = v.y;
    } else {
        c[0] = *src;
    }
}

// The warp route: one warp a merge, IT = W / 32 cells a lane.
template <int IT>
__global__ void __launch_bounds__(WARP_BLOCK) merge_warp_kernel(
    const float* __restrict__ cost, int Pp, int rows,
    const int32_t* __restrict__ la_p, const int32_t* __restrict__ lb_p,
    const int32_t* __restrict__ lo_p, const int32_t* __restrict__ kmax_p,
    int8_t* choices, int32_t* __restrict__ jmat)
{
    constexpr int W = 32 * IT;
    constexpr int NW = (IT + 3) / 4;  // 32-bit words of a lane's choice bytes
    const int lane = threadIdx.x & 31;
    const int p = blockIdx.x * (WARP_BLOCK / 32) + (threadIdx.x >> 5);
    if (p >= Pp) return;  // a whole warp
    const int la = la_p[p];
    const int lb = lb_p[p];
    const int lo = lo_p[p];
    const int kmax = kmax_p[p];
    const int k0 = lane * IT;
    const int top = la < rows ? la : rows;

    float S[IT];
#pragma unroll
    for (int u = 0; u < IT; ++u) {
        const int k = k0 + u;
        S[u] = (lo + k >= 0 && k <= kmax) ? 0.0f : NEG;
    }
    const float* crow = cost + (size_t)p * rows * W + k0;
    float c[IT];
    if (top >= 1) load_costs<IT>(crow, c);

    for (int i = 1; i <= top; ++i) {
        float cn[IT];
        if (i < top) load_costs<IT>(crow + (size_t)i * W, cn);
        float s_nb = __shfl_down_sync(FULL, S[0], 1);  // k0 + IT, row i - 1
        if (lane == 31) s_nb = NEG;  // k + 1 == W: outside the band
        const int jb = i + lo + k0;

        float M[IT], sup[IT], run[IT];
        float tmax = NEG;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const int j = jb + u;
            M[u] = S[u] + ((j >= 1 && j <= lb) ? c[u] : NEG);
            sup[u] = u + 1 < IT ? S[u + 1] : s_nb;
            tmax = fmaxf(tmax, fmaxf(M[u], sup[u]));
            run[u] = tmax;
        }
        float x = tmax;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(FULL, x, off);
            if (lane >= off) x = fmaxf(x, y);
        }
        float excl = __shfl_up_sync(FULL, x, 1);
        if (lane == 0) excl = NEG;

        uint32_t wd[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) wd[w] = 0;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const int k = k0 + u;
            const int j = jb + u;
            const bool valid = j >= 0 && j <= lb && k <= kmax;
            const float sn = valid ? fmaxf(excl, run[u]) : NEG;
            const int choice = (M[u] >= sn) ? 0 : ((sup[u] >= sn) ? 2 : 1);
            S[u] = sn;
            wd[u >> 2] |= (uint32_t)choice << (8 * (u & 3));
        }
        int8_t* dst = choices + ((size_t)(i - 1) * Pp + p) * W + k0;
        if constexpr (IT == 1) *dst = (int8_t)wd[0];
        else if constexpr (IT == 2) *reinterpret_cast<uint16_t*>(dst) = (uint16_t)wd[0];
        else if constexpr (IT == 4) *reinterpret_cast<uint32_t*>(dst) = wd[0];
        else if constexpr (IT == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(wd[0], wd[1]);
        else *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
#pragma unroll
        for (int u = 0; u < IT; ++u) c[u] = cn[u];
    }
    __syncwarp();  // the lanes' choice bytes visible to the whole warp
    merge_walk(choices, Pp, rows, W, p, la, lb, lo, lane, jmat);
}

// The block route: one block a merge, chunks of blockDim.x cells, S rows
// in ``scratch`` (the merge's [2, W] slice).
__global__ void __launch_bounds__(BLOCK_THREADS) merge_block_kernel(
    const float* __restrict__ cost, int Pp, int rows, int W,
    const int32_t* __restrict__ la_p, const int32_t* __restrict__ lb_p,
    const int32_t* __restrict__ lo_p, const int32_t* __restrict__ kmax_p,
    float* scratch, int8_t* choices, int32_t* __restrict__ jmat)
{
    __shared__ float sWarp[2][BLOCK_THREADS / 32];
    const int p = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nthr = blockDim.x;
    const int nwarps = nthr >> 5;
    const int la = la_p[p];
    const int lb = lb_p[p];
    const int lo = lo_p[p];
    const int kmax = kmax_p[p];
    const int top = la < rows ? la : rows;
    float* const buf = scratch + (size_t)p * 2 * W;

    for (int k = t; k < W; k += nthr) buf[k] = (lo + k >= 0 && k <= kmax) ? 0.0f : NEG;
    __syncthreads();

    int par = 0;
    for (int i = 1; i <= top; ++i) {
        const float* cur = buf + (size_t)((i - 1) & 1) * W;  // row i - 1
        float* nxt = buf + (size_t)(i & 1) * W;              // row i
        const float* crow = cost + ((size_t)p * rows + (i - 1)) * W;
        int8_t* drow = choices + ((size_t)(i - 1) * Pp + p) * W;
        float carry = NEG;  // running max of the chunks before
        for (int c0 = 0; c0 < W; c0 += nthr) {
            const int k = c0 + t;
            const int j = i + lo + k;
            const float m = cur[k] + ((j >= 1 && j <= lb) ? crow[k] : NEG);
            const float sup = k + 1 < W ? cur[k + 1] : NEG;
            float x = fmaxf(m, sup);
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float y = __shfl_up_sync(FULL, x, off);
                if (lane >= off) x = fmaxf(x, y);
            }
            float* sw = sWarp[par];
            par ^= 1;
            if (lane == 31) sw[warp] = x;
            __syncthreads();
            float pre = carry, total = carry;
            for (int w = 0; w < nwarps; ++w) {
                if (w < warp) pre = fmaxf(pre, sw[w]);
                total = fmaxf(total, sw[w]);
            }
            const bool valid = j >= 0 && j <= lb && k <= kmax;
            const float sn = valid ? fmaxf(pre, x) : NEG;
            nxt[k] = sn;
            drow[k] = (int8_t)((m >= sn) ? 0 : ((sup >= sn) ? 2 : 1));
            carry = total;
        }
        __syncthreads();  // row i complete before row i + 1 reads it
    }
    if (warp == 0) merge_walk(choices, Pp, rows, W, p, la, lb, lo, lane, jmat);
}

// The kernel of a route (0 warp, 1 block) at band width W, or null; the
// route's threads a block.
const void* kernel_for(int route, int W, int* threads)
{
    if (W < 32 || (W & (W - 1))) return nullptr;
    if (route == 1) {
        if (W < BLOCK_THREADS) return nullptr;
        *threads = BLOCK_THREADS;
        return (const void*)merge_block_kernel;
    }
    if (route != 0) return nullptr;
    *threads = WARP_BLOCK;
    switch (W) {
    case 32: return (const void*)merge_warp_kernel<1>;
    case 64: return (const void*)merge_warp_kernel<2>;
    case 128: return (const void*)merge_warp_kernel<4>;
    case 256: return (const void*)merge_warp_kernel<8>;
    case 512: return (const void*)merge_warp_kernel<16>;
    default: return nullptr;
    }
}

template <int IT>
int launch_warp(const float* cost, int Pp, int rows, const int32_t* la, const int32_t* lb,
                const int32_t* lo, const int32_t* kmax, int8_t* choices, int32_t* jmat,
                cudaStream_t stream)
{
    const int blocks = (Pp + WARP_BLOCK / 32 - 1) / (WARP_BLOCK / 32);
    merge_warp_kernel<IT><<<blocks, WARP_BLOCK, 0, stream>>>(
        cost, Pp, rows, la, lb, lo, kmax, choices, jmat);
    return (int)cudaGetLastError();
}

}  // namespace

// cost float32 [Pp, rows, W]; la, lb, lo, kmax int32 [Pp]; choices int8
// [rows, Pp, W] (scratch); jmat int32 [rows, Pp], zeroed by the caller.
// route 0 (warp): W a power of two from 32 to 512.  route 1 (block): W a
// power of two from 256 up, ``scratch`` float32 [Pp, 2, W].  Anything else
// is refused (cudaErrorInvalidValue).
extern "C" int sarlacc_merge_kernel(
    const float* cost, int Pp, int rows, int W,
    const int32_t* la, const int32_t* lb, const int32_t* lo, const int32_t* kmax,
    int route, float* scratch, int8_t* choices, int32_t* jmat, void* stream)
{
    int threads = 0;
    if (!kernel_for(route, W, &threads) || rows < 0) return (int)cudaErrorInvalidValue;
    if (route == 1 && !scratch) return (int)cudaErrorInvalidValue;
    if (Pp <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (route == 1) {
        merge_block_kernel<<<Pp, threads, 0, s>>>(
            cost, Pp, rows, W, la, lb, lo, kmax, scratch, choices, jmat);
        return (int)cudaGetLastError();
    }
    switch (W) {
    case 32: return launch_warp<1>(cost, Pp, rows, la, lb, lo, kmax, choices, jmat, s);
    case 64: return launch_warp<2>(cost, Pp, rows, la, lb, lo, kmax, choices, jmat, s);
    case 128: return launch_warp<4>(cost, Pp, rows, la, lb, lo, kmax, choices, jmat, s);
    case 256: return launch_warp<8>(cost, Pp, rows, la, lb, lo, kmax, choices, jmat, s);
    default: return launch_warp<16>(cost, Pp, rows, la, lb, lo, kmax, choices, jmat, s);
    }
}

// Resources of a route's kernel at band width W: out[0..4] = registers a
// thread, static shared bytes a block, local (spill) bytes a thread,
// resident blocks an SM, threads a block.
extern "C" int sarlacc_merge_attrs(int route, int W, int* out)
{
    int threads = 0;
    const void* fn = kernel_for(route, W, &threads);
    if (!fn) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = (int)a.localSizeBytes;
    out[3] = blocks;
    out[4] = threads;
    return 0;
}
