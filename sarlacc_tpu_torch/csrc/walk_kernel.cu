// Kernel F: the Gotoh walk of the MSA library's read pairs over kernel B's
// direction bits, with each pair's identity.
//
// Replaces sarlacc_tpu/ops/msa.py::_pair_walk_kernel (a lax.scan over the
// DP rows with a while_loop inside each row) and ::_pair_ident_kernel.
// Plain PyTorch versions: sarlacc_tpu_torch/ops/msa.py::_pair_walk_kernel
// and ::_pair_ident_kernel; jmat and identities are bit-identical.
//
// Inputs: the [rows, P, W] int8 direction bytes csrc/pair_kernel.cu writes
// (bits 0-1 the choice: 0 diagonal, 1 horizontal, 2 vertical; bit 2 the
// horizontal extend; bit 3 the vertical extend), lens_a, lens_b and lo
// [P], and the padded codes [P, la_w] and [P, lb_w].  Band coordinates:
// cell (i, j) sits at k = j - i - lo.
//
// One warp a pair, walking the rows from min(la, rows) down.  The state is
// the column k and S or V; every lane keeps the same copy, so only the
// searches below split work over the lanes.  Per row:
//   * V state: one vertical move, k + 1, staying in V while the cell's
//     vertical-extend bit is set;
//   * S state: the choice at k; a horizontal run hops to one column below
//     pz_h, the largest k' <= k whose horizontal-extend bit is 0 (the
//     reference's full-row cummax), found by a __ballot_sync over 32 cells
//     at a time scanning downward; a hop to k' <= kz (j = 0) or k' < 0 kills
//     the pair.  A legal hop always lowers k, so a chain takes at most W + 1
//     hops, and the loop is bounded by that.  A choice of 3 (never written
//     by kernel B) ends the chain unresolved at its column, in S.
// Every lookup clamps k into [0, W - 1] (the reference's gather_k); the
// emitted j = r + lo + k is not clamped.  A diagonal exit at row r emits
// jmat[r - 1, p] (the wrapper zero-fills jmat) and counts the match and
// whether A's code at r equals B's at j (A's code past la_w counts as 0, B's
// index clamps into [0, lb_w - 1], as _pair_ident_kernel's gather does);
// the identity is eq / max(cnt, 1), divided in float32 with round to
// nearest.  A pair that is inactive (j <= 0, lb <= 0) or dead stays so on
// every lower row, so its walk stops there.
//
// What bounds it: latency.  A row's lookups depend on the column the row
// above resolved, so a pair is a chain of about la dependent steps.  So the
// walk reads its rows through windows: at a window's first row r, lane l
// copies row r - l's 64 direction bytes around the column (four 16-byte
// cp.async into the warp's [32][64] shared window), and rows r .. r - 31
// resolve from shared memory while the column stays inside it.  A column
// that leaves it (a horizontal hop past its edge, the vertical drift of
// many rows) opens a new window at that row; a run-end ballot that scans
// below the window reads the cells outside it from device memory.  So the
// chain waits on device memory about once a window, not once a row.  A
// diagonal exit only notes its j in the lane that holds its row; when the
// window closes, each lane writes its row's jmat and compares its codes,
// and the counts are summed over the warp at the end (integer sums, so
// exact in any order).  Its compulsory traffic is one 32-byte sector of
// directions per walked row, the compared codes and jmat; a window reads
// 64 bytes a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WALK_BLOCK = 128;  // four pairs a block
constexpr int WIN = 64;          // direction bytes a window row

__device__ __forceinline__ int clamp_k(int k, int W)
{
    return k < 0 ? 0 : (k > W - 1 ? W - 1 : k);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::);
}

// Largest k' <= c (0 <= c < W) whose horizontal-extend bit is 0, or -1:
// 32 cells a step, lane l testing cell base - l; ``cell(x)`` reads byte x
// of the row.
template <typename Cell>
__device__ __forceinline__ int run_end(const Cell& cell, int c, int lane)
{
    for (int base = c; base >= 0; base -= 32) {
        const int idx = base - lane;
        const bool hit = idx >= 0 && ((cell(idx) >> 2) & 1) == 0;
        const unsigned m = __ballot_sync(FULL, hit);
        if (m) return base - (__ffs(m) - 1);
    }
    return -1;
}

__global__ void __launch_bounds__(WALK_BLOCK) walk_kernel(
    const int8_t* __restrict__ dirs, int P, int rows, int W, int vec,
    const int32_t* __restrict__ lens_a, const int32_t* __restrict__ lens_b,
    const int32_t* __restrict__ lo_p,
    const int8_t* __restrict__ codes_a, int la_w,
    const int8_t* __restrict__ codes_b, int lb_w,
    int32_t* __restrict__ jmat, float* __restrict__ ident)
{
    __shared__ __align__(16) int8_t sWin[WALK_BLOCK / 32][32][WIN];
    const int lane = threadIdx.x & 31;
    const int p = blockIdx.x * (WALK_BLOCK / 32) + (threadIdx.x >> 5);
    if (p >= P) return;  // a whole warp
    int8_t (*const win)[WIN] = sWin[threadIdx.x >> 5];
    const int la = lens_a[p];
    const int lb = lens_b[p];
    const int lo = lo_p[p];
    const int8_t* a = codes_a + (size_t)p * la_w;
    const int8_t* b = codes_b + (size_t)p * lb_w;
    const int wc = W < WIN ? W : WIN;  // cells of a window row
    // The walk enters at (la, lb) when la is a row, else at row ``rows``
    // with k = 0 (as the reference's scan leaves it); a pair with lb <= 0
    // is inactive on every row.
    const int top = lb <= 0 ? 0 : (la < rows ? la : rows);
    int k = la <= rows ? lb - la - lo : 0;
    bool vstate = false;
    int cnt = 0, eq = 0;  // this lane's rows' share of the identity's counts
    int jpend = 0;        // j emitted at this lane's row of the window, or 0
    int wtop = 0, wbase = 0;  // the window's first row (0: none yet) and cell
    size_t rowoff = (size_t)(top - 1) * P + p;  // row r's [P, W] offset, in rows of W

    // The closing window's emitted rows: jmat and the code comparison.
    auto flush = [&]() {
        if (jpend > 0) {
            const int r = wtop - lane;
            jmat[(size_t)(r - 1) * P + p] = jpend;
            const int ai = r - 1 < la_w ? (int)a[r - 1] : 0;
            const int jb = jpend - 1 > lb_w - 1 ? lb_w - 1 : jpend - 1;
            cnt += 1;
            eq += ai == (int)b[jb];
            jpend = 0;
        }
    };

    for (int r = top; r >= 1; --r, rowoff -= P) {
        if (r + lo + k <= 0) break;  // inactive now and below
        const int c = clamp_k(k, W);
        if ((unsigned)(wtop - r) >= 32u || (unsigned)(c - wbase) >= (unsigned)wc) {
            flush();
            wtop = r;
            const int lowest = (c - 24) & ~15;
            wbase = lowest < 0 ? 0 : (lowest > W - wc ? W - wc : lowest);
            __syncwarp();  // every lane is done with the old window
            if (r - lane >= 1) {  // row r - lane in slot lane
                const int8_t* src = dirs + (rowoff - (size_t)lane * P) * W + wbase;
                if (vec) {
                    for (int q = 0; q < wc; q += 16) cp_async16(&win[lane][q], src + q);
                    cp_async_wait_all();
                } else {
                    for (int q = 0; q < wc; ++q) win[lane][q] = src[q];
                }
            }
            __syncwarp();
        }
        const int8_t* wrow = win[wtop - r];
        // Byte x of row r: from the window, or from device memory outside it.
        auto cell = [&](int x) -> int {
            const int d = x - wbase;
            return (unsigned)d < (unsigned)wc ? (int)wrow[d] : (int)dirs[rowoff * W + x];
        };
        if (vstate) {
            vstate = (cell(c) >> 3) & 1;
            k += 1;
            continue;
        }
        const int kz = -(r + lo);
        int kk = k, x = c, d = 0, ch = 0;
        bool died = false;
        for (int hop = 0; hop <= W; ++hop) {
            d = cell(x);
            ch = d & 3;
            if (ch != 1) break;
            kk = run_end(cell, x, lane) - 1;
            if (kk <= kz || kk < 0) {
                died = true;
                break;
            }
            x = clamp_k(kk, W);
        }
        if (died) break;
        if (ch == 0) {
            if (lane == wtop - r) jpend = r + lo + kk;
        } else if (ch == 2) {
            vstate = (d >> 3) & 1;
            kk += 1;
        }
        k = kk;
    }
    flush();
    cnt = __reduce_add_sync(FULL, cnt);
    eq = __reduce_add_sync(FULL, eq);
    if (lane == 0) ident[p] = __fdiv_rn((float)eq, (float)(cnt > 0 ? cnt : 1));
}

}  // namespace

// dirs int8 [rows, P, W]; lens_a, lens_b, lo int32 [P]; codes_a int8 [P,
// la_w]; codes_b int8 [P, lb_w] (lb_w >= 1); jmat int32 [rows, P], zeroed
// by the caller; ident float32 [P].  W >= 1.
extern "C" int sarlacc_walk_kernel(
    const int8_t* dirs, int P, int rows, int W,
    const int32_t* lens_a, const int32_t* lens_b, const int32_t* lo,
    const int8_t* codes_a, int la_w, const int8_t* codes_b, int lb_w,
    int32_t* jmat, float* ident, void* stream)
{
    if (W < 1 || rows < 0 || la_w < 0 || lb_w < 1) return (int)cudaErrorInvalidValue;
    if (P <= 0) return 0;
    // Rows on 16-byte boundaries take the window by cp.async, others byte by byte.
    const int vec = (W % 16 == 0) && ((uintptr_t)dirs % 16 == 0);
    const int blocks = (P + WALK_BLOCK / 32 - 1) / (WALK_BLOCK / 32);
    walk_kernel<<<blocks, WALK_BLOCK, 0, (cudaStream_t)stream>>>(
        dirs, P, rows, W, vec, lens_a, lens_b, lo, codes_a, la_w, codes_b, lb_w, jmat, ident);
    return (int)cudaGetLastError();
}

// Resources: out[0..4] = registers a thread, static shared bytes a block,
// local (spill) bytes a thread, resident blocks an SM, threads a block.
extern "C" int sarlacc_walk_attrs(int* out)
{
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, walk_kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, walk_kernel, WALK_BLOCK, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = (int)a.localSizeBytes;
    out[3] = blocks;
    out[4] = WALK_BLOCK;
    return 0;
}
