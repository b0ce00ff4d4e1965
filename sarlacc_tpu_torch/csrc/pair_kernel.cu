// Kernel B: banded global Gotoh alignment of P read pairs (MSA library).
//
// Replaces sarlacc_tpu/ops/pallas_msa.py::_kernel (launched by _launch /
// banded_pair_pallas).  Plain PyTorch version:
// sarlacc_tpu_torch/ops/cuda_msa.py::banded_pair_plain; scores and direction
// bits are bit-identical.
//
// Band coordinates: DP cell (i, j) sits at k = j - i - lo, 0 <= k <= kmax.
// One block per pair walks the rows in order; the band of W cells is spread
// over the block's threads, IT consecutive cells each.  Per row:
//   1. each thread reads the previous row's S and V (shared memory) at k and
//      k+1, forms the diagonal M, the vertical Vn and B = (mv - go) + k*ge,
//      and a running max of B over its own cells;
//   2. a block-wide exclusive max-scan of the per-thread maxima (warp
//      shuffles, then one warp over the warp totals) completes the
//      horizontal cummax (pallas_msa.py:171-179);
//   3. each thread closes Hn = cum[k-1] - (k-1)*ge, resolves the choice
//      (diagonal, then horizontal, then vertical, with >=) and the extend
//      bits, and writes its W/threads direction bytes for this row.
// Max is exact, so the scan order does not change any bit.
//
// What bounds it: the row loop is sequential, so a pair's latency is rows x
// (three block barriers + a scan); throughput comes from many pairs in
// flight (one block each, 256 threads at W >= 256, several blocks per SM).
// Direction bytes, rows x W per pair, are the only large traffic; each row
// is written as one contiguous W-byte run in the [rows, P, W] layout, so
// the stores coalesce.  The previous row lives in shared memory, never in
// device memory.
//
// Exactness: compile with --fmad=false so (mv - go) + k*ge,
// -(go + (j-1)*ge) and cum - (k-1)*ge are not contracted into FMAs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1.0e9f;

template <int IT>
__global__ void pair_kernel(
    const int8_t* __restrict__ codes_a, int la_w,
    const int8_t* __restrict__ codes_b, int lb_w,
    const int32_t* __restrict__ lens_a, const int32_t* __restrict__ lens_b,
    const int32_t* __restrict__ lo_p, const int32_t* __restrict__ kmax_p,
    int P, int rows, int W, float mt, float mm, float go, float ge,
    int8_t* __restrict__ dirs, float* __restrict__ scores)
{
    extern __shared__ float smem[];
    float* sS = smem;            // previous row's S, [W]
    float* sV = sS + W;          // previous row's V, [W]
    float* sMV = sV + W;         // this row's unmasked mv, [W]
    float* sH = sMV + W;         // this row's masked Hn, [W]
    float* sWarp = sH + W;       // warp maxima for the scan, [32]

    const int p = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nwarps = blockDim.x >> 5;
    const int k0 = t * IT;

    const int la = lens_a[p];
    const int lb = lens_b[p];
    const int lo = lo_p[p];
    const int kmax = kmax_p[p];
    const int8_t* a = codes_a + (size_t)p * la_w;
    const int8_t* b = codes_b + (size_t)p * lb_w;

    // Row 0: S = 0 at j == 0, -(go + (j-1)*ge) inside [1, lb] and the band.
#pragma unroll
    for (int u = 0; u < IT; ++u) {
        const int k = k0 + u;
        const int j0 = lo + k;
        float s = NEG;
        if (j0 == 0) s = 0.0f;
        else if (j0 >= 1 && j0 <= lb && k <= kmax) s = -(go + ((float)j0 - 1.0f) * ge);
        sS[k] = s;
        sV[k] = NEG;
    }
    __syncthreads();

    for (int i = 1; i <= rows; ++i) {
        const bool alive = i <= la;
        const int ai = (i - 1 < la_w) ? (int)a[i - 1] : 5;

        float M[IT], Vn[IT], run[IT];
        bool vext[IT];
        float tmax = NEG;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const int k = k0 + u;
            const int j = i + lo + k;
            float sub = NEG;
            if (j >= 1 && j <= lb) sub = (ai == (int)b[j - 1]) ? mt : mm;
            M[u] = sS[k] + sub;
            const float s_up = (k + 1 < W) ? sS[k + 1] : NEG;
            const float v_up = (k + 1 < W) ? sV[k + 1] : NEG;
            const float open_v = s_up - go;
            const float ext_v = v_up - ge;
            Vn[u] = fmaxf(open_v, ext_v);
            vext[u] = ext_v >= open_v;
            const float mv = fmaxf(M[u], Vn[u]);
            sMV[k] = mv;
            tmax = fmaxf(tmax, (mv - go) + (float)k * ge);
            run[u] = tmax;
        }

        // Block-wide exclusive max-scan of the per-thread maxima.
        float x = tmax;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(0xffffffffu, x, off);
            if (lane >= off) x = fmaxf(x, y);
        }
        float lane_excl = __shfl_up_sync(0xffffffffu, x, 1);
        if (lane == 0) lane_excl = NEG;
        if (lane == 31) sWarp[warp] = x;
        __syncthreads();  // S/V reads done; warp maxima and sMV visible
        if (warp == 0) {
            float w = (lane < nwarps) ? sWarp[lane] : NEG;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float y = __shfl_up_sync(0xffffffffu, w, off);
                if (lane >= off) w = fmaxf(w, y);
            }
            sWarp[lane] = w;
        }
        __syncthreads();
        const float excl = fmaxf(warp > 0 ? sWarp[warp - 1] : NEG, lane_excl);

        float Sn[IT];
        int choice[IT];
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const int k = k0 + u;
            const int j = i + lo + k;
            const bool valid = j >= 0 && j <= lb && k <= kmax;
            const float cprev = (u == 0) ? excl : fmaxf(excl, run[u - 1]);
            float h = NEG;
            if (k > 0 && valid) h = cprev - ((float)k - 1.0f) * ge;
            const float m = valid ? M[u] : NEG;
            const float v = valid ? Vn[u] : NEG;
            Sn[u] = fmaxf(m, fmaxf(h, v));
            choice[u] = (m >= Sn[u]) ? 0 : ((h >= Sn[u]) ? 1 : 2);
            sH[k] = h;
            Vn[u] = v;
        }
        __syncthreads();  // sH complete

        int8_t* drow = dirs + ((size_t)(i - 1) * P + p) * W;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const int k = k0 + u;
            const float h_prev = (k > 0) ? sH[k - 1] : NEG;
            const float mv_prev = (k > 0) ? sMV[k - 1] : NEG;
            const bool hext = (h_prev - ge) >= (mv_prev - go);
            drow[k] = (int8_t)(choice[u] | ((int)hext << 2) | ((int)vext[u] << 3));
            if (alive) {
                sS[k] = Sn[u];
                sV[k] = Vn[u];
            }
        }
        __syncthreads();  // next row reads the new S/V
    }

    const int kfin = lb - la - lo;
    if (t == 0) scores[p] = (kfin >= 0 && kfin < W) ? sS[kfin] : NEG;
}

template <int IT>
int launch(const int8_t* codes_a, int la_w, const int8_t* codes_b, int lb_w,
           const int32_t* lens_a, const int32_t* lens_b, const int32_t* lo,
           const int32_t* kmax, int P, int rows, int W, float mt, float mm,
           float go, float ge, int8_t* dirs, float* scores, cudaStream_t stream)
{
    const int threads = W / IT;
    const size_t smem = (4 * (size_t)W + 32) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pair_kernel<IT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    pair_kernel<IT><<<P, threads, smem, stream>>>(
        codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W,
        mt, mm, go, ge, dirs, scores);
    return (int)cudaGetLastError();
}

}  // namespace

// W must be a power of two from 32 to 4096; threads = min(W, 256), so each
// thread keeps at most 16 band cells (IT = 16 takes ~170 registers a thread,
// which 256 threads fit in one SM's register file and 512 do not).
extern "C" int sarlacc_pair_kernel(
    const int8_t* codes_a, int la_w, const int8_t* codes_b, int lb_w,
    const int32_t* lens_a, const int32_t* lens_b, const int32_t* lo,
    const int32_t* kmax, int P, int rows, int W, float mt, float mm, float go,
    float ge, int8_t* dirs, float* scores, void* stream)
{
    if (P <= 0) return 0;
    if (W < 32 || W > 4096 || (W & (W - 1))) return (int)cudaErrorInvalidValue;
    const int threads = W < 256 ? W : 256;
    const int it = W / threads;
    cudaStream_t s = (cudaStream_t)stream;
    switch (it) {
        case 1: return launch<1>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, dirs, scores, s);
        case 2: return launch<2>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, dirs, scores, s);
        case 4: return launch<4>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, dirs, scores, s);
        case 8: return launch<8>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, dirs, scores, s);
        case 16: return launch<16>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, dirs, scores, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
