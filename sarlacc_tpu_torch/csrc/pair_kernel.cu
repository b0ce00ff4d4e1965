// Kernel B: banded global Gotoh alignment of P read pairs (MSA library).
//
// Replaces sarlacc_tpu/ops/pallas_msa.py::_kernel (launched by _launch /
// banded_pair_pallas).  Plain PyTorch version:
// sarlacc_tpu_torch/ops/cuda_msa.py::banded_pair_plain; scores and direction
// bits are bit-identical.
//
// Band coordinates: DP cell (i, j) sits at k = j - i - lo, 0 <= k <= kmax.
// A pair walks the rows in order, the band of W cells spread over its
// threads, IT consecutive cells each.  Three routes, chosen by W in the
// wrapper (ops/cuda_msa.py::pair_route):
//
// Warp route (W 32-512, every band the pipeline's buckets give): one warp
// a pair, IT = W / 32 cells a lane in registers, four pairs a block and no
// block barrier.  Per row a lane
//   1. takes the previous row's S and V at k+1 from its own registers, or
//      for its last cell from lane + 1 (__shfl_down_sync), forms the
//      diagonal M, the vertical Vn and B = (mv - go) + k*ge, and a running
//      max of B over its cells;
//   2. completes the horizontal cummax (pallas_msa.py:171-179) with a
//      5-step warp scan of the lane maxima (exclusive by one more shuffle);
//   3. closes Hn = cum[k-1] - (k-1)*ge, resolves the choice (diagonal, then
//      horizontal, then vertical, with >=) and the horizontal-extend bit,
//      whose H and mv at k-1 come from lane - 1 (__shfl_up_sync) for its
//      first cell, and stores its IT direction bytes as one vector store.
//   Sequence B's codes ride the band in a register window: a row later
//   cell k reads what cell k+1 read, so the window shifts by one cell a row
//   (its last cell from lane + 1) and only lane 31 loads a new code.  A's
//   codes come 32 rows at a time, one a lane, and reach the warp by a
//   broadcast shuffle.
//
// Block route (W 1024-4096): one block a pair, 256 threads; the previous
// row's S and V, this row's mv and H and the scan's warp maxima live in
// shared memory, with four block barriers a row.
//
// Wide route (W 8192-65536, bands of reads that differ by kilobases; down
// to 256 when measurement forces it): a thread-block cluster a pair, W /
// 8192 blocks (1, 2, 4 or 8) of up to 512 threads, each block a contiguous
// slice of the band, IT <= 16 consecutive cells a thread, and every row's
// S, V and B's codes in registers, as on the warp route: no DP state in
// device memory.  A warp's cells are a segment.  Across segments a row
// needs the scan's carry (the max of the earlier segments' maxima), H and
// mv at the cell before a segment, and the previous row's S and V at the
// cell after it; all three follow from what each segment knows after its
// first pass (pair_wide_kernel below), so each warp publishes a five-float
// summary into every block's shared memory of the cluster (distributed
// shared memory, double-buffered by row parity) and the row has one cluster
// barrier.  Each direction byte is formed once and stored with the lane's
// others as one vector store.
//
// What bounds it: the ALU and the row's shuffle chain on the warp route.
// Per cell ~21 counted float operations (substitution select, M, the
// vertical gap, mv, B and its running max, the closed horizontal gap, the
// masks, S and the choice) against one direction byte; a row's latency is
// its chain of about a dozen shuffles (five of them the dependent scan),
// so throughput comes from many pairs (warps) in flight: about 480 GCUPS
// at W 256 and 4 blocks an SM, less at W 512 (202 registers, 2 blocks) and
// at a few hundred pairs.  Direction bytes, rows x W per pair, are the only
// large traffic: each row is one contiguous W-byte run in the [rows, P, W]
// layout, written as one 1-16-byte store a lane.  No DP state goes to
// device memory on any route.
//
// Exactness: compile with --fmad=false so (mv - go) + k*ge,
// -(go + (j-1)*ge) and cum - (k-1)*ge are not contracted into FMAs.  Max is
// exact, so the scan order does not change any bit.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1.0e9f;

// The block route: one block per pair, W / IT threads of IT band cells.
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

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_BLOCK = 128;  // four pairs a block on the warp route

// The warp route: one warp per pair, IT = W / 32 band cells a lane.
template <int IT>
__global__ void __launch_bounds__(WARP_BLOCK) pair_warp_kernel(
    const int8_t* __restrict__ codes_a, int la_w,
    const int8_t* __restrict__ codes_b, int lb_w,
    const int32_t* __restrict__ lens_a, const int32_t* __restrict__ lens_b,
    const int32_t* __restrict__ lo_p, const int32_t* __restrict__ kmax_p,
    int P, int rows, float mt, float mm, float go, float ge,
    int8_t* __restrict__ dirs, float* __restrict__ scores)
{
    constexpr int W = 32 * IT;
    constexpr int NW = (IT + 3) / 4;  // 32-bit words of a lane's direction bytes
    const int lane = threadIdx.x & 31;
    const int p = blockIdx.x * (WARP_BLOCK / 32) + (threadIdx.x >> 5);
    if (p >= P) return;  // a whole warp: no barrier follows
    const int k0 = lane * IT;

    const int la = lens_a[p];
    const int lb = lens_b[p];
    const int lo = lo_p[p];
    const int kmax = kmax_p[p];
    const int8_t* a = codes_a + (size_t)p * la_w;
    const int8_t* b = codes_b + (size_t)p * lb_w;

    // Row 0: S = 0 at j == 0, -(go + (j-1)*ge) inside [1, lb] and the band.
    float S[IT], V[IT];
    int bw[IT];  // B's code at this row's cell, -1 outside [1, lb]
#pragma unroll
    for (int u = 0; u < IT; ++u) {
        const int k = k0 + u;
        const int j0 = lo + k;
        float s = NEG;
        if (j0 == 0) s = 0.0f;
        else if (j0 >= 1 && j0 <= lb && k <= kmax) s = -(go + ((float)j0 - 1.0f) * ge);
        S[u] = s;
        V[u] = NEG;
        const int j = 1 + lo + k;
        bw[u] = (j >= 1 && j <= lb) ? (int)b[j - 1] : -1;
    }
    int areg = 5;  // A's code at row (i - 1) & ~31 + lane

    for (int i = 1; i <= rows; ++i) {
        if (((i - 1) & 31) == 0) {
            const int r = i - 1 + lane;
            areg = r < la_w ? (int)a[r] : 5;
        }
        const int ai = __shfl_sync(FULL, areg, (i - 1) & 31);
        const bool alive = i <= la;
        float s_nb = __shfl_down_sync(FULL, S[0], 1);  // k0 + IT, one row up
        float v_nb = __shfl_down_sync(FULL, V[0], 1);
        if (lane == 31) s_nb = v_nb = NEG;  // k + 1 == W: outside the band

        float M[IT], Vn[IT], mv[IT], run[IT];
        bool vext[IT];
        float tmax = NEG;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const int k = k0 + u;
            const float sub = bw[u] < 0 ? NEG : (ai == bw[u] ? mt : mm);
            M[u] = S[u] + sub;
            const float s_up = u + 1 < IT ? S[u + 1] : s_nb;
            const float v_up = u + 1 < IT ? V[u + 1] : v_nb;
            const float open_v = s_up - go;
            const float ext_v = v_up - ge;
            Vn[u] = fmaxf(open_v, ext_v);
            vext[u] = ext_v >= open_v;
            mv[u] = fmaxf(M[u], Vn[u]);
            tmax = fmaxf(tmax, (mv[u] - go) + (float)k * ge);
            run[u] = tmax;
        }

        // Warp-wide exclusive max-scan of the lane maxima.
        float x = tmax;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(FULL, x, off);
            if (lane >= off) x = fmaxf(x, y);
        }
        float excl = __shfl_up_sync(FULL, x, 1);
        if (lane == 0) excl = NEG;

        float h[IT];
        uint32_t wd[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) wd[w] = 0;
        const int jb = i + lo + k0;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const int k = k0 + u;
            const int j = jb + u;
            const bool valid = j >= 0 && j <= lb && k <= kmax;
            const float cprev = (u == 0) ? excl : fmaxf(excl, run[u - 1]);
            float hh = NEG;
            if (k > 0 && valid) hh = cprev - ((float)k - 1.0f) * ge;
            const float m = valid ? M[u] : NEG;
            const float v = valid ? Vn[u] : NEG;
            const float sn = fmaxf(m, fmaxf(hh, v));
            const int choice = (m >= sn) ? 0 : ((hh >= sn) ? 1 : 2);
            h[u] = hh;
            M[u] = sn;  // this row's S
            Vn[u] = v;
            wd[u >> 2] |= (uint32_t)(choice | ((int)vext[u] << 3)) << (8 * (u & 3));
        }
        float h_nb = __shfl_up_sync(FULL, h[IT - 1], 1);  // k0 - 1, this row
        float mv_nb = __shfl_up_sync(FULL, mv[IT - 1], 1);
        if (lane == 0) h_nb = mv_nb = NEG;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const float h_prev = u == 0 ? h_nb : h[u - 1];
            const float mv_prev = u == 0 ? mv_nb : mv[u - 1];
            const bool hext = (h_prev - ge) >= (mv_prev - go);
            wd[u >> 2] |= (uint32_t)hext << (8 * (u & 3) + 2);
        }

        int8_t* dst = dirs + ((size_t)(i - 1) * P + p) * W + k0;
        if constexpr (IT == 1) *dst = (int8_t)wd[0];
        else if constexpr (IT == 2) *reinterpret_cast<uint16_t*>(dst) = (uint16_t)wd[0];
        else if constexpr (IT == 4) *reinterpret_cast<uint32_t*>(dst) = wd[0];
        else if constexpr (IT == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(wd[0], wd[1]);
        else *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);

        if (alive) {
#pragma unroll
            for (int u = 0; u < IT; ++u) {
                S[u] = M[u];
                V[u] = Vn[u];
            }
        }
        // Slide B's window: row i + 1's cell k reads row i's cell k + 1.
        const int b_nb = __shfl_down_sync(FULL, bw[0], 1);
#pragma unroll
        for (int u = 0; u + 1 < IT; ++u) bw[u] = bw[u + 1];
        bw[IT - 1] = b_nb;
        if (lane == 31) {
            const int j = i + 1 + lo + W - 1;
            bw[IT - 1] = (j >= 1 && j <= lb) ? (int)b[j - 1] : -1;
        }
    }

    const int kfin = lb - la - lo;
    if (kfin < 0 || kfin >= W) {
        if (lane == 0) scores[p] = NEG;
    } else {
#pragma unroll
        for (int u = 0; u < IT; ++u)
            if (k0 + u == kfin) scores[p] = S[u];
    }
}

template <int IT>
int launch_warp(const int8_t* codes_a, int la_w, const int8_t* codes_b, int lb_w,
                const int32_t* lens_a, const int32_t* lens_b, const int32_t* lo,
                const int32_t* kmax, int P, int rows, float mt, float mm, float go,
                float ge, int8_t* dirs, float* scores, cudaStream_t stream)
{
    const int blocks = (P + WARP_BLOCK / 32 - 1) / (WARP_BLOCK / 32);
    pair_warp_kernel<IT><<<blocks, WARP_BLOCK, 0, stream>>>(
        codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, mt, mm, go, ge,
        dirs, scores);
    return (int)cudaGetLastError();
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

constexpr int WIDE_THREADS = 512;      // the wide route's block, at most
constexpr int WIDE_BLOCK_CELLS = 8192; // band cells a block, at most (16 a thread)
constexpr int WIDE_MAX_CLUSTER = 8;    // blocks a cluster, at most (portable)
constexpr int WIDE_MAX_SEG = WIDE_MAX_CLUSTER * WIDE_THREADS / 32;  // warps a cluster
// A warp's summary of its row, published to every block of the cluster:
// the maximum of B over its cells, the maximum of B over all but its last
// cell, mv at its last cell, and M and Vn (unmasked) at its first cell.
enum { F_MAX, F_XL, F_MVL, F_M0, F_V0, F_COUNT };

__device__ __forceinline__ void cluster_barrier()
{
    __syncwarp();  // the .aligned forms want the whole warp converged
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The wide route: a cluster of C blocks a pair (blockIdx.x / C), block r of
// the cluster holding band cells [r * W / C, (r + 1) * W / C), IT
// consecutive cells a thread, S, V and B's codes in registers.  A warp's 32
// x IT cells are a segment; within a segment the lanes talk by shuffles as
// on the warp route.  Across segments (warps, and blocks) everything one
// row needs is known after that row's first pass, so a row has one cluster
// barrier:
//   * the scan's carry into segment g is the max of the segments' maxima
//     before it (a max, so exact in any order);
//   * H and mv at the cell before segment g's first come from segment
//     g - 1's summary (its maximum less the last cell, its last mv);
//   * S and V of the previous row at the cell after segment g's last (a
//     halo pair of registers in lane 31) are recomputed from segment g +
//     1's published M and Vn and the carry, the same expressions in the
//     same order as g + 1 evaluates, so they are the same bits.
// Each warp's lanes 0..C-1 write its summary into the shared memory of
// every block of the cluster (distributed shared memory), in the slot of
// the row's parity: a slot is rewritten two rows later, after every reader
// has passed the barrier between.  Each thread stores its IT direction
// bytes as one vector store.
// The substitution score at a lane's cell u of the wide route, from its
// packed window of B's codes (a byte a cell, 0xff outside [1, lb]).
template <int NW>
__device__ __forceinline__ float wide_sub(const uint32_t (&bw)[NW], int u, int ai, float mt,
                                          float mm)
{
    const int c = (int)(int8_t)(bw[u >> 2] >> (8 * (u & 3)));
    return c < 0 ? NEG : (ai == c ? mt : mm);
}

template <int IT>
__global__ void __launch_bounds__(WIDE_THREADS, 1) pair_wide_kernel(
    const int8_t* __restrict__ codes_a, int la_w,
    const int8_t* __restrict__ codes_b, int lb_w,
    const int32_t* __restrict__ lens_a, const int32_t* __restrict__ lens_b,
    const int32_t* __restrict__ lo_p, const int32_t* __restrict__ kmax_p,
    int P, int rows, int W, float mt, float mm, float go, float ge,
    int8_t* __restrict__ dirs, float* __restrict__ scores)
{
    constexpr int SEG = 32 * IT;
    constexpr int NW = (IT + 3) / 4;  // 32-bit words of a lane's direction bytes (and B codes)
    __shared__ float summ[2][F_COUNT][WIDE_MAX_SEG];

    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int p = blockIdx.x / C;
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const int g = rank * nwarps + (threadIdx.x >> 5);  // segment
    const int nseg = C * nwarps;
    const int k0w = g * SEG;         // the segment's first cell
    const int k0 = k0w + lane * IT;  // the lane's first cell
    const float kf0 = (float)k0;     // + u is exact: (float)(k0 + u)

    const int la = lens_a[p];
    const int lb = lens_b[p];
    const int lo = lo_p[p];
    const int kmax = kmax_p[p];
    const int8_t* a = codes_a + (size_t)p * la_w;
    const int8_t* b = codes_b + (size_t)p * lb_w;
    const bool last_seg = g == nseg - 1;
    const int kw = k0w + SEG - 1;  // the segment's last cell

    // Row 0: S = 0 at j == 0, -(go + (j-1)*ge) inside [1, lb] and the band.
    float S[IT], V[IT];
    uint32_t bw[NW];  // B's code at this row's cell, a byte a cell, 0xff outside [1, lb]
#pragma unroll
    for (int w = 0; w < NW; ++w) bw[w] = 0;
#pragma unroll
    for (int u = 0; u < IT; ++u) {
        const int k = k0 + u;
        const int j0 = lo + k;
        float s = NEG;
        if (j0 == 0) s = 0.0f;
        else if (j0 >= 1 && j0 <= lb && k <= kmax) s = -(go + ((float)j0 - 1.0f) * ge);
        S[u] = s;
        V[u] = NEG;
        const int j = 1 + lo + k;
        const int c = (j >= 1 && j <= lb) ? (int)b[j - 1] : -1;
        bw[u >> 2] |= (uint32_t)(c & 0xff) << (8 * (u & 3));
    }
    // The halo: S and V of the previous row at the next segment's first cell.
    float Sh = NEG, Vh = NEG;
    if (!last_seg) {
        const int c = kw + 1;
        const int j0 = lo + c;
        if (j0 == 0) Sh = 0.0f;
        else if (j0 >= 1 && j0 <= lb && c <= kmax) Sh = -(go + ((float)j0 - 1.0f) * ge);
    }
    int areg = 5;   // A's code at row (i - 1) & ~31 + lane
    int breg = -1;  // lane 31's next code, for row (i - 1) & ~31 + lane

    for (int i = 1; i <= rows; ++i) {
        const int par = i & 1;
        if (((i - 1) & 31) == 0) {
            const int r = i - 1 + lane;
            areg = r < la_w ? (int)a[r] : 5;
            const int jn = i + 1 + lane + lo + kw;  // lane 31's cell kw, row i + lane + 1
            breg = (jn >= 1 && jn <= lb) ? (int)b[jn - 1] : -1;
        }
        const int ai = __shfl_sync(FULL, areg, (i - 1) & 31);
        const bool alive = i <= la;
        const int kv0 = -(i + lo);                       // valid: j >= 0 ...
        const int kv1 = min(lb - i - lo, kmax);          // ... j <= lb, k <= kmax
        float s_nb = __shfl_down_sync(FULL, S[0], 1);  // k0 + IT, one row up
        float v_nb = __shfl_down_sync(FULL, V[0], 1);
        if (lane == 31) {
            s_nb = Sh;
            v_nb = Vh;
        }

        // Pass 1: M and Vn at the first cell, mv at the last, and the lane's
        // running maximum of B = (mv - go) + k*ge (t2: all but the last cell).
        float tmax = NEG, t2 = NEG, M0, V0, mvL;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const float sub = wide_sub(bw, u, ai, mt, mm);
            const float M = S[u] + sub;
            const float s_up = u + 1 < IT ? S[u + 1] : s_nb;
            const float v_up = u + 1 < IT ? V[u + 1] : v_nb;
            const float Vn = fmaxf(s_up - go, v_up - ge);
            const float mv = fmaxf(M, Vn);
            if (u == 0) {
                M0 = M;
                V0 = Vn;
            }
            if (u == IT - 1) {
                mvL = mv;
                t2 = tmax;
            }
            tmax = fmaxf(tmax, (mv - go) + (kf0 + (float)u) * ge);
        }

        // The segment's inclusive scan of the lane maxima.
        float x = tmax;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(FULL, x, off);
            if (lane >= off) x = fmaxf(x, y);
        }
        float lane_excl = __shfl_up_sync(FULL, x, 1);
        if (lane == 0) lane_excl = NEG;
        const float f_max = __shfl_sync(FULL, x, 31);
        const float f_xl = __shfl_sync(FULL, fmaxf(lane_excl, t2), 31);
        const float f_mvl = __shfl_sync(FULL, mvL, 31);
        const float f_m0 = __shfl_sync(FULL, M0, 0);
        const float f_v0 = __shfl_sync(FULL, V0, 0);
        if (lane < C) {
            float* dst = cluster.map_shared_rank(&summ[par][0][0], lane);
            dst[F_MAX * WIDE_MAX_SEG + g] = f_max;
            dst[F_XL * WIDE_MAX_SEG + g] = f_xl;
            dst[F_MVL * WIDE_MAX_SEG + g] = f_mvl;
            dst[F_M0 * WIDE_MAX_SEG + g] = f_m0;
            dst[F_V0 * WIDE_MAX_SEG + g] = f_v0;
        }
        cluster_barrier();
        const float* sm = &summ[par][0][0];
        // Pass 2 recomputes pass 1's cell values (M, Vn, mv): keeping them
        // across the barrier spills at 16 cells a thread.  The empty asm
        // marks S and V as rewritten, so pass 1's values cannot be reused.
#pragma unroll
        for (int u = 0; u < IT; ++u) asm volatile("" : "+f"(S[u]), "+f"(V[u]));
        asm volatile("" : "+f"(s_nb), "+f"(v_nb));

        // The carries: max of the maxima of the segments before g - 1 and g.
        float carry_m1 = NEG, carry = NEG;
        for (int q = lane; q < g - 1; q += 32)
            carry_m1 = fmaxf(carry_m1, sm[F_MAX * WIDE_MAX_SEG + q]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            carry_m1 = fmaxf(carry_m1, __shfl_xor_sync(FULL, carry_m1, off));
        if (g > 0) carry = fmaxf(carry_m1, sm[F_MAX * WIDE_MAX_SEG + g - 1]);
        const float excl = fmaxf(carry, lane_excl);

        // H and mv at the cell before the lane's first: from lane - 1's last
        // cell, or for lane 0 from segment g - 1's summary.
        float h_last = NEG;
        {
            const int kL = k0 + IT - 1;
            if (kL > 0 && kL >= kv0 && kL <= kv1)
                h_last = fmaxf(excl, t2) - ((kf0 + (float)(IT - 1)) - 1.0f) * ge;
        }
        float h_nb = __shfl_up_sync(FULL, h_last, 1);
        float mv_nb = __shfl_up_sync(FULL, mvL, 1);
        if (lane == 0) {
            h_nb = mv_nb = NEG;
            if (g > 0) {
                mv_nb = sm[F_MVL * WIDE_MAX_SEG + g - 1];
                const int kk = k0w - 1;
                if (kk > 0 && kk >= kv0 && kk <= kv1)
                    h_nb = fmaxf(carry_m1, sm[F_XL * WIDE_MAX_SEG + g - 1]) -
                           ((float)kk - 1.0f) * ge;
            }
        }

        // Pass 2: each cell's S, V, choice and both extend bits, in order.
        uint32_t wd[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) wd[w] = 0;
        float run = excl, hp = h_nb, mvp = mv_nb;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const int k = k0 + u;
            const float kf = kf0 + (float)u;
            const float sub = wide_sub(bw, u, ai, mt, mm);
            const float M = S[u] + sub;
            const float s_up = u + 1 < IT ? S[u + 1] : s_nb;
            const float v_up = u + 1 < IT ? V[u + 1] : v_nb;
            const float open_v = s_up - go;
            const float ext_v = v_up - ge;
            const float Vn = fmaxf(open_v, ext_v);
            const bool vext = ext_v >= open_v;
            const float mv = fmaxf(M, Vn);
            const bool valid = k >= kv0 && k <= kv1;
            float h = NEG;
            if (k > 0 && valid) h = run - (kf - 1.0f) * ge;
            const float m = valid ? M : NEG;
            const float v = valid ? Vn : NEG;
            const float sn = fmaxf(m, fmaxf(h, v));
            const int choice = (m >= sn) ? 0 : ((h >= sn) ? 1 : 2);
            const bool hext = (hp - ge) >= (mvp - go);
            wd[u >> 2] |= (uint32_t)(choice | ((int)hext << 2) | ((int)vext << 3))
                          << (8 * (u & 3));
            run = fmaxf(run, (mv - go) + kf * ge);
            hp = h;
            mvp = mv;
            if (alive) {
                S[u] = sn;
                V[u] = v;
            }
        }

        int8_t* dst = dirs + ((size_t)(i - 1) * P + p) * W + k0;
        if constexpr (IT == 1) *dst = (int8_t)wd[0];
        else if constexpr (IT == 2) *reinterpret_cast<uint16_t*>(dst) = (uint16_t)wd[0];
        else if constexpr (IT == 4) *reinterpret_cast<uint32_t*>(dst) = wd[0];
        else if constexpr (IT == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(wd[0], wd[1]);
        else *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);

        // The halo for the next row: segment g + 1's first cell, as g + 1
        // computes it.
        if (lane == 31 && !last_seg) {
            const int c = kw + 1;
            const bool valid = c >= kv0 && c <= kv1;
            float h = NEG;
            if (c > 0 && valid) h = fmaxf(carry, f_max) - ((float)c - 1.0f) * ge;
            const float m = valid ? sm[F_M0 * WIDE_MAX_SEG + g + 1] : NEG;
            const float v = valid ? sm[F_V0 * WIDE_MAX_SEG + g + 1] : NEG;
            if (alive) {
                Sh = fmaxf(m, fmaxf(h, v));
                Vh = v;
            }
        }
        // Slide B's window: row i + 1's cell k reads row i's cell k + 1.
        const uint32_t b_nb = __shfl_down_sync(FULL, bw[0] & 0xffu, 1);
        const uint32_t b_new = (uint32_t)__shfl_sync(FULL, breg, (i - 1) & 31) & 0xffu;
#pragma unroll
        for (int w = 0; w + 1 < NW; ++w) bw[w] = (bw[w] >> 8) | (bw[w + 1] << 24);
        bw[NW - 1] = (bw[NW - 1] >> 8) | ((lane == 31 ? b_new : b_nb) << (8 * ((IT - 1) & 3)));
    }

    const int kfin = lb - la - lo;
    if (kfin < 0 || kfin >= W) {
        if (g == 0 && lane == 0) scores[p] = NEG;
    } else {
#pragma unroll
        for (int u = 0; u < IT; ++u)
            if (k0 + u == kfin) scores[p] = S[u];
    }
    cluster_barrier();  // no block leaves while a peer may still address its shared memory
}

template <int IT>
int launch_wide(const int8_t* codes_a, int la_w, const int8_t* codes_b, int lb_w,
                const int32_t* lens_a, const int32_t* lens_b, const int32_t* lo,
                const int32_t* kmax, int P, int rows, int W, float mt, float mm, float go,
                float ge, int cluster, int8_t* dirs, float* scores, cudaStream_t stream)
{
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)P * cluster);
    cfg.blockDim = dim3(W / cluster / IT);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, pair_wide_kernel<IT>, codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P,
        rows, W, mt, mm, go, ge, dirs, scores);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// The wide route's plan at band width W: cells a thread (1-16), threads a
// block and blocks a cluster, the fewest blocks of at most 8192 cells (512
// threads of 16) that hold the band; 0 if the kernel lacks W.
int wide_cells(int W, int* threads, int* cluster)
{
    if (W < 256 || W > 65536 || (W & (W - 1))) return 0;
    *cluster = W > WIDE_BLOCK_CELLS ? W / WIDE_BLOCK_CELLS : 1;
    const int cells = W / *cluster;
    *threads = cells < WIDE_THREADS ? cells : WIDE_THREADS;
    return cells / *threads;
}

const void* wide_kernel(int IT)
{
    switch (IT) {
    case 1: return (const void*)pair_wide_kernel<1>;
    case 2: return (const void*)pair_wide_kernel<2>;
    case 4: return (const void*)pair_wide_kernel<4>;
    case 8: return (const void*)pair_wide_kernel<8>;
    case 16: return (const void*)pair_wide_kernel<16>;
    default: return nullptr;
    }
}

// The kernel of the warp (0) or block (1) route at band width W, or null;
// the route's threads a block at W.
const void* kernel_for(int route, int W, int* threads)
{
    if (W < 32 || W > 4096 || (W & (W - 1))) return nullptr;
    if (route == 0) {
        *threads = WARP_BLOCK;
        switch (W) {
        case 32: return (const void*)pair_warp_kernel<1>;
        case 64: return (const void*)pair_warp_kernel<2>;
        case 128: return (const void*)pair_warp_kernel<4>;
        case 256: return (const void*)pair_warp_kernel<8>;
        case 512: return (const void*)pair_warp_kernel<16>;
        default: return nullptr;
        }
    }
    if (route != 1) return nullptr;
    *threads = W < 256 ? W : 256;
    switch (W / *threads) {
    case 1: return (const void*)pair_kernel<1>;
    case 2: return (const void*)pair_kernel<2>;
    case 4: return (const void*)pair_kernel<4>;
    case 8: return (const void*)pair_kernel<8>;
    case 16: return (const void*)pair_kernel<16>;
    default: return nullptr;
    }
}

}  // namespace

// route 0 (warp): W a power of two from 32 to 512, one warp a pair.
// route 1 (block): W a power of two from 32 to 4096; threads = min(W, 256),
// so each thread keeps at most 16 band cells (IT = 16 takes ~170 registers
// a thread, which 256 threads fit in one SM's register file and 512 do
// not).
// route 2 (wide): W a power of two from 256 to 65536, a cluster of W / 8192
// blocks a pair above 8192 cells, one block up to it (wide_cells).  No
// device scratch on any route.
// Anything else is refused (cudaErrorInvalidValue); a launch the card
// refuses (a cluster it cannot place) returns its error.
extern "C" int sarlacc_pair_kernel(
    const int8_t* codes_a, int la_w, const int8_t* codes_b, int lb_w,
    const int32_t* lens_a, const int32_t* lens_b, const int32_t* lo,
    const int32_t* kmax, int P, int rows, int W, float mt, float mm, float go,
    float ge, int route, int8_t* dirs, float* scores, void* stream)
{
    int threads = 0, cluster = 1;
    const int IT = route == 2 ? wide_cells(W, &threads, &cluster) : 0;
    if (route == 2 ? !IT : !kernel_for(route, W, &threads)) return (int)cudaErrorInvalidValue;
    if (P <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (route == 2) {
        switch (IT) {
            case 1: return launch_wide<1>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, cluster, dirs, scores, s);
            case 2: return launch_wide<2>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, cluster, dirs, scores, s);
            case 4: return launch_wide<4>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, cluster, dirs, scores, s);
            case 8: return launch_wide<8>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, cluster, dirs, scores, s);
            default: return launch_wide<16>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, cluster, dirs, scores, s);
        }
    }
    if (route == 0) {
        switch (W) {
            case 32: return launch_warp<1>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, mt, mm, go, ge, dirs, scores, s);
            case 64: return launch_warp<2>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, mt, mm, go, ge, dirs, scores, s);
            case 128: return launch_warp<4>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, mt, mm, go, ge, dirs, scores, s);
            case 256: return launch_warp<8>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, mt, mm, go, ge, dirs, scores, s);
            default: return launch_warp<16>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, mt, mm, go, ge, dirs, scores, s);
        }
    }
    switch (W / threads) {
        case 1: return launch<1>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, dirs, scores, s);
        case 2: return launch<2>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, dirs, scores, s);
        case 4: return launch<4>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, dirs, scores, s);
        case 8: return launch<8>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, dirs, scores, s);
        default: return launch<16>(codes_a, la_w, codes_b, lb_w, lens_a, lens_b, lo, kmax, P, rows, W, mt, mm, go, ge, dirs, scores, s);
    }
}

// Resources of the warp or block route's kernel at band width W: out[0..4]
// = registers a thread, static shared bytes a block, local (spill) bytes a
// thread, resident blocks an SM (the block route with its dynamic shared
// memory), threads a block.
extern "C" int sarlacc_pair_attrs(int route, int W, int* out)
{
    int threads = 0;
    const void* fn = kernel_for(route, W, &threads);
    if (!fn) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = route == 1 ? (4 * (size_t)W + 32) * sizeof(float) : 0;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = (int)a.localSizeBytes;
    out[3] = blocks;
    out[4] = threads;
    return 0;
}

// Resources of the wide route's kernel at band width W: out[0..4] as
// sarlacc_pair_attrs, out[5] = blocks a cluster, out[6] = clusters the card
// can hold at once (cudaOccupancyMaxActiveClusters).
extern "C" int sarlacc_pair_wide_attrs(int W, int* out)
{
    int threads = 0, cluster = 1;
    const void* fn = wide_kernel(wide_cells(W, &threads, &cluster));
    if (!fn) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = (int)a.localSizeBytes;
    out[3] = blocks;
    out[4] = threads;
    out[5] = cluster;
    out[6] = active;
    return 0;
}
