// Kernels C and D: score-only quality-aware fitting/global affine-gap DP,
// for N reads against one IUPAC reference (C) or against many reference
// segments in one launch (D).
//
// Kernel C replaces sarlacc_tpu/ops/pallas_align.py::_kernel (launched by
// _launch_planes / fit_scores_from_planes); kernel D replaces
// _segments_kernel (launched by _launch_segments / fit_scores_segments).
// Plain PyTorch versions: sarlacc_tpu_torch/ops/align.py::dp_scores and
// ::dp_scores_segments; scores are bit-identical.
//
// Work decomposition.  One thread owns one (read, segment) pair: the grid
// is blocks of THREADS reads on x (reads on the fast axis of every
// [l1, n_pad] plane, so a warp's loads are coalesced) by segments on y.
// Kernel C is the same body with one segment and the gather of [N]
// lengths.
//
// Loop order.  Rows outer, columns inner, inside column tiles of TJ
// columns.  Per thread the previous row's S at the tile's columns and each
// column's running vertical-gap max live in registers (fully unrolled, no
// dynamic index); this row's left S and H are scalars carried along the
// columns.  No DP state goes to device memory: a reference longer than one
// tile hands the tile's last column (S and H at rows 0..len, 8 bytes a row)
// to the next tile through a scratch slot, read and overwritten in place.
// Every cell keeps the expression of the column-outer kernel and every
// column's running max still accumulates over rows in ascending order, so
// the bits cannot change.  In fitting mode the last column (free vertical
// gaps) is peeled off the tile loop, so the ordinary columns carry no
// select.
//
// Costs per row.  At row i a thread loads the read's code once and, of the
// [4, l1, n_pad] match/mismatch planes, only the slots the tile's columns
// use, into its own column of a shared row table; a cell reads its cost
// from that table at a byte offset staged per block for (code, column),
// so there is no per-cell select on the mode.  Loads for row i+1 are
// issued before row i is computed.
//
// What bounds it: the ALU.  Per cell: 6 float adds, 4 maxes, 2 shared
// loads and an integer add; the only device-memory traffic is a code and
// 2-8 costs a row (plus the tile hand-off of long references) and one
// score per (read, segment).
//
// Ablation.  The body takes compile-time flags (F below) that each remove
// one part of its work, for attributing kernel C's time on the card
// (csrc/score_ablation.cu, tools/score_ablation.py): NO_VGAP drops the
// columns' running vertical-gap max (s = mv; 3 adds and 2 maxes of a
// cell's 6 + 4), NO_DYNCOST takes the cost (code == 1 ? -0.1 : -1.0) for
// the whole row instead of the two shared loads a cell (no cost slot is
// fetched, no row table filled), NO_ROWLOAD fetches row i + 1's code and
// costs at row (i + 1) & row_mask (0 from the ablation's wrapper), so the
// loads stay but hit L1: a provably constant address would let the
// compiler drop them.  Kernels C and D are the body with no flag; this
// file's entries never set one.  Defining SCORE_BODY_ONLY before including
// this file leaves out kernel D and the entry points.
//
// Exactness: compile with --fmad=false.  The association
// (mv - go) + i*ge and cum - (i-1)*ge must not contract into FMAs, or the
// last bit moves and the barcode argmax can flip on a tie.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -3.0e38f;
constexpr int THREADS = 128;
constexpr int NCODE = 8;         // codes 0..7; 5 (padding) and above never match

// Ablation flags of the body (F); kernels C and D take none.
constexpr int NO_VGAP = 1, NO_DYNCOST = 2, NO_ROWLOAD = 4;

// Tile widths: TJ = 2 * TOP - 1 columns in blocks of TOP, TOP/2, ..., 1.
// The wrapper takes the narrowest of 15, 31 and 63 that holds the launch's
// widest segment (63 and several tiles beyond): the registers of unused
// columns would only cost occupancy.  Resident blocks an SM asked of the
// compiler, so that each width fits without spilling; a build may set
// them (-DSCORE_MIN_BLOCKS_15=... and so on), which tools/score_tiles.py
// sweeps.
#ifndef SCORE_MIN_BLOCKS_15
#define SCORE_MIN_BLOCKS_15 7
#endif
#ifndef SCORE_MIN_BLOCKS_31
#define SCORE_MIN_BLOCKS_31 4
#endif
#ifndef SCORE_MIN_BLOCKS_63
#define SCORE_MIN_BLOCKS_63 3
#endif
constexpr int min_blocks(int top)
{
    return top >= 32 ? SCORE_MIN_BLOCKS_63 : top >= 16 ? SCORE_MIN_BLOCKS_31 : SCORE_MIN_BLOCKS_15;
}

template <int TOP>
struct Shared {
    static constexpr int TJ = 2 * TOP - 1;
    static constexpr int KSTR = TJ + 2;  // TJ columns and the peeled one; odd,
                                         // so the codes' rows fall in distinct banks
    int koff[NCODE][KSTR];      // byte offset into tab for (code, column)
    float tab[8][THREADS];      // this row's costs: slot m match, 4 + m mismatch
    int need;                   // bit k: slot k is used by the tile
};

// The register state of a tile's columns, in blocks of W, W/2, ..., 1
// columns (W a power of two).  A tile of tl columns runs the blocks whose
// bit is set in tl, widest first, each fully unrolled: no cell carries a
// bound check, which would cut the row into one basic block a cell.
template <int W, int F>
struct Tile {
    float pS[W];   // S at the previous row
    float cum[W];  // running max of B over the rows above
    Tile<W / 2, F> rest;

    __device__ __forceinline__ void init()
    {
#pragma unroll
        for (int jj = 0; jj < W; ++jj) {
            pS[jj] = NEG;
            cum[jj] = NEG;
        }
        rest.init();
    }

    // One row of the tile's ordinary columns.  sL/hL: S and H of the
    // column to the left at this row; diag: its S at the row above; crow:
    // the row's cost under NO_DYNCOST.
    __device__ __forceinline__ void row(
        int tl, const int* kr, const char* tab, float crow, float go, float ge, float rge,
        float rge1, float& sL, float& hL, float& diag)
    {
        constexpr bool vgap = !(F & NO_VGAP);
        if (tl & W) {
#pragma unroll
            for (int jj = 0; jj < W; ++jj) {
                const float cost = (F & NO_DYNCOST) ? crow
                                                    : *reinterpret_cast<const float*>(tab + kr[jj]);
                const float Hn = fmaxf(sL - go, hL - ge);
                const float M = diag + cost;
                const float mv = fmaxf(M, Hn);
                const float V = cum[jj] - rge1;
                const float B = (mv - go) + rge;
                const float s = vgap ? fmaxf(mv, V) : mv;
                diag = pS[jj];
                pS[jj] = s;
                if (vgap) cum[jj] = fmaxf(cum[jj], B);
                sL = s;
                hL = Hn;
            }
            kr += W;
        }
        rest.row(tl, kr, tab, crow, go, ge, rge, rge1, sL, hL, diag);
    }
};

template <int F>
struct Tile<0, F> {
    __device__ __forceinline__ void init() {}
    __device__ __forceinline__ void row(
        int, const int*, const char*, float, float, float, float, float, float&, float&,
        float&) {}
};

__device__ __forceinline__ int cost_slot(
    const int32_t* __restrict__ modes, const int32_t* __restrict__ mask, int j, int c)
{
    const int m = min(max(modes[j], 1), 4) - 1;  // modes are 1..4
    return ((mask[j] >> c) & 1) ? m : 4 + m;
}

__device__ __forceinline__ uint64_t global_ns()
{
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// One thread's DP of the read in lane n (rows 0..len; len < 0: no rows,
// the thread only joins the block's barriers) against columns
// modes/mask[0, rlen).  Returns S at row len after the last column
// (column 0's value when rlen == 0).  bS/bH: the tile hand-off slot
// ([l1, n_pad] each), needed only when the ordinary columns exceed TJ.
// F: ablation flags; row_mask is read only under NO_ROWLOAD.
template <int TOP, int F = 0>
__device__ float score_one(
    Shared<TOP>& sh, int n, int len, const int32_t* __restrict__ modes,
    const int32_t* __restrict__ mask, int rlen, bool local, float go, float ge,
    const float* __restrict__ costm, const float* __restrict__ costmm,
    const int32_t* __restrict__ codes_k, int n_pad, size_t plane,
    float* __restrict__ bS, float* __restrict__ bH, int row_mask = 0)
{
    constexpr int TJ = Shared<TOP>::TJ;
    const int tid = threadIdx.x;
    const bool peel = local && rlen > 0;  // last column: free trailing gaps
    const int rn = rlen - (peel ? 1 : 0);
    const int ntiles = rn > TJ ? (rn + TJ - 1) / TJ : 1;
    const char* tab = reinterpret_cast<const char*>(&sh.tab[0][tid]);
    float sL = 0.0f;

    for (int t = 0; t < ntiles; ++t) {
        const int j0 = t * TJ;
        const int tl = min(TJ, rn - j0);
        const bool last = t == ntiles - 1;
        const bool zv = peel && last;

        // Stage the tile's (code, column) -> table offsets.
        __syncthreads();  // the previous tile's rows are done with koff
        if (tid == 0) sh.need = 0;
        __syncthreads();
        int need = 0;
        const int ncol = tl + (zv ? 1 : 0);  // the peeled column goes to koff[c][TJ]
        for (int e = tid; !(F & NO_DYNCOST) && e < NCODE * ncol; e += THREADS) {
            const int c = e / ncol, q = e % ncol;
            const int k = cost_slot(modes, mask, q < tl ? j0 + q : rlen - 1, c);
            need |= 1 << k;
            sh.koff[c][q < tl ? q : TJ] = k * THREADS * (int)sizeof(float);
        }
        if (need) atomicOr(&sh.need, need);
        __syncthreads();
        need = (F & NO_DYNCOST) ? 0 : sh.need;
        if (len < 0) continue;

        Tile<TOP, F> cols;
        cols.init();
        float cumZ = NEG;  // the peeled column's running max
        float dL = NEG;    // S(i-1) of the column left of the tile

        int code_nx = codes_k[n];
        float v_nx[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            v_nx[k] = (need >> k) & 1 ? (k < 4 ? costm : costmm)[(k & 3) * plane + n] : 0.0f;

        for (int i = 0; i <= len; ++i) {
            const size_t at = (size_t)i * n_pad + n;
            const float fi = (float)i;
            const float rge = fi * ge;
            const float rge1 = (fi - 1.0f) * ge;

            float hL;
            if (t == 0) {  // column 0 (reference_align.cpp:65-74)
                sL = (local || i == 0) ? 0.0f : (-go) - rge1;
                hL = NEG;
            } else {
                sL = bS[at];
                hL = bH[at];
            }
            float diag = dL;
            dL = sL;

            const int* kr = sh.koff[min((unsigned)code_nx, (unsigned)NCODE - 1)];
            const float crow = code_nx == 1 ? -0.1f : -1.0f;  // NO_DYNCOST's cost
#pragma unroll
            for (int k = 0; k < 8; ++k)
                if ((need >> k) & 1) sh.tab[k][tid] = v_nx[k];
            if (i < len) {  // prefetch row i + 1
                const size_t nx = (F & NO_ROWLOAD) ? (size_t)((i + 1) & row_mask) * n_pad + n
                                                   : at + n_pad;
                code_nx = codes_k[nx];
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    if ((need >> k) & 1) v_nx[k] = (k < 4 ? costm : costmm)[(k & 3) * plane + nx];
            }

            cols.row(tl, kr, tab, crow, go, ge, rge, rge1, sL, hL, diag);
            if (zv) {  // the peeled last column: V carries no ramp, B = mv
                const float cost = (F & NO_DYNCOST) ? crow
                                                    : *reinterpret_cast<const float*>(tab + kr[TJ]);
                const float Hn = fmaxf(sL - go, hL - ge);
                const float mv = fmaxf(diag + cost, Hn);
                sL = (F & NO_VGAP) ? mv : fmaxf(mv, cumZ);
                hL = Hn;
                if (!(F & NO_VGAP)) cumZ = fmaxf(cumZ, mv);
            }
            if (!last) {  // hand the tile's last column to the next tile
                bS[at] = sL;
                bH[at] = hL;
            }
        }
    }
    return sL;
}

__device__ int clamp_len(int len, int l1)
{
    return len < 0 ? 0 : (len > l1 - 1 ? l1 - 1 : len);
}

// stamps (measurement only; null from the public wrappers): per block
// {start ns, end ns, SM id}, the end taken once every thread of the block
// is done.
__device__ __forceinline__ void stamp(uint64_t* stamps, int at, uint64_t t0)
{
    if (!stamps) return;  // a kernel argument: the same for every thread
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned smid;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
        stamps[3 * at] = t0;
        stamps[3 * at + 1] = global_ns();
        stamps[3 * at + 2] = smid;
    }
}

// Kernel C (F = 0) and the ablation variants (csrc/score_ablation.cu).
template <int TOP, int F>
__global__ void __launch_bounds__(THREADS, min_blocks(TOP)) score_kernel(
    const int32_t* __restrict__ modes, const int32_t* __restrict__ mask,
    int rlen, float go, float ge, int local,
    const float* __restrict__ costm, const float* __restrict__ costmm,
    const int32_t* __restrict__ codes_k, const int32_t* __restrict__ lengths,
    int n, int l1, int n_pad, float* __restrict__ scratch,
    float* __restrict__ out, uint64_t* __restrict__ stamps, int row_mask)
{
    __shared__ Shared<TOP> sh;
    const uint64_t t0 = stamps ? global_ns() : 0;
    const int t = blockIdx.x * THREADS + threadIdx.x;
    const size_t plane = (size_t)l1 * n_pad;
    const int len = t < n ? clamp_len(lengths[t], l1) : -1;
    const float s = score_one<TOP, F>(
        sh, t, len, modes, mask, rlen, local != 0, go, ge, costm, costmm,
        codes_k, n_pad, plane, scratch, scratch ? scratch + plane : nullptr, row_mask);
    if (t < n) out[t] = s;
    stamp(stamps, blockIdx.x, t0);
}

// score_kernel<., F> at tile width tj (15, 31 or 63), or null.
template <int F>
const void* score_kernel_for(int tj)
{
    switch (tj) {
    case 15: return (const void*)score_kernel<8, F>;
    case 31: return (const void*)score_kernel<16, F>;
    case 63: return (const void*)score_kernel<32, F>;
    default: return nullptr;
    }
}

// Launch score_kernel<., F>: a CUDA error code (0 on success); a tile width
// other than 15, 31 or 63 is refused (cudaErrorInvalidValue).
template <int F>
int launch_score(
    const int32_t* modes, const int32_t* mask, int rlen, float go, float ge,
    int local, const float* costm, const float* costmm, const int32_t* codes_k,
    const int32_t* lengths, int n, int l1, int n_pad, int tj, float* scratch,
    float* out, uint64_t* stamps, int row_mask, void* stream)
{
    const void* fn = score_kernel_for<F>(tj);
    if (!fn) return (int)cudaErrorInvalidValue;
    if (n <= 0 || l1 <= 0) return 0;
    void* args[] = {&modes, &mask, &rlen, &go, &ge, &local, &costm, &costmm, &codes_k,
                    &lengths, &n, &l1, &n_pad, &scratch, &out, &stamps, &row_mask};
    const dim3 grid((n + THREADS - 1) / THREADS);
    return (int)cudaLaunchKernel(fn, grid, dim3(THREADS), args, 0, (cudaStream_t)stream);
}

// A kernel's resources: out[0..4] = registers a thread, static shared
// bytes a block, local (spill) bytes a thread, resident blocks an SM,
// threads a block.
int kernel_attrs(const void* fn, int* out)
{
    if (!fn) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = (int)a.localSizeBytes;
    out[3] = blocks;
    out[4] = THREADS;
    return 0;
}

}  // namespace

#ifndef SCORE_BODY_ONLY

namespace {

// seg_i [nseg, 4] = (start, rlen, local, scratch slot or -1; segments
// run concurrently, so each wide one of a launch has its own slot); seg_f
// [nseg, 2] = (go, ge) with go already open + extend.  Every lane of n_pad
// runs; padded lanes carry length 0 and so compute row 0 only.
template <int TOP>
__global__ void __launch_bounds__(THREADS, min_blocks(TOP)) segments_kernel(
    const int32_t* __restrict__ modes, const int32_t* __restrict__ mask,
    const int32_t* __restrict__ seg_i, const float* __restrict__ seg_f,
    const float* __restrict__ costm, const float* __restrict__ costmm,
    const int32_t* __restrict__ codes_k, const int32_t* __restrict__ lens_k,
    int l1, int n_pad, float* __restrict__ scratch, float* __restrict__ out,
    uint64_t* __restrict__ stamps)
{
    __shared__ Shared<TOP> sh;
    const uint64_t t0 = stamps ? global_ns() : 0;
    const int s = blockIdx.y;
    const int t = blockIdx.x * THREADS + threadIdx.x;
    const size_t plane = (size_t)l1 * n_pad;
    const int start = seg_i[4 * s], slot = seg_i[4 * s + 3];
    float* bS = slot >= 0 ? scratch + 2 * plane * slot : nullptr;
    out[(size_t)s * n_pad + t] = score_one(
        sh, t, clamp_len(lens_k[t], l1), modes + start, mask + start,
        seg_i[4 * s + 1], seg_i[4 * s + 2] != 0, seg_f[2 * s], seg_f[2 * s + 1],
        costm, costmm, codes_k, n_pad, plane, bS, bS ? bS + plane : nullptr);
    stamp(stamps, s * gridDim.x + blockIdx.x, t0);
}

// The instantiation of tile width tj (15, 31 or 63), or null.
const void* kernel_for(int which, int tj)
{
    if (which == 0) return score_kernel_for<0>(tj);
    switch (tj) {
    case 15: return (const void*)segments_kernel<8>;
    case 31: return (const void*)segments_kernel<16>;
    case 63: return (const void*)segments_kernel<32>;
    default: return nullptr;
    }
}

}  // namespace

// Both entry points return a CUDA error code (0 on success); a tile width
// other than 15, 31 or 63 is refused (cudaErrorInvalidValue).

extern "C" int sarlacc_score_kernel(
    const int32_t* modes, const int32_t* mask, int rlen, float go, float ge,
    int local, const float* costm, const float* costmm, const int32_t* codes_k,
    const int32_t* lengths, int n, int l1, int n_pad, int tj, float* scratch,
    float* out, uint64_t* stamps, void* stream)
{
    return launch_score<0>(modes, mask, rlen, go, ge, local, costm, costmm, codes_k, lengths,
                           n, l1, n_pad, tj, scratch, out, stamps, 0, stream);
}

extern "C" int sarlacc_segments_kernel(
    const int32_t* modes, const int32_t* mask, const int32_t* seg_i,
    const float* seg_f, int nseg, const float* costm, const float* costmm,
    const int32_t* codes_k, const int32_t* lens_k, int l1, int n_pad, int tj,
    float* scratch, float* out, uint64_t* stamps, void* stream)
{
    const void* fn = kernel_for(1, tj);
    if (!fn || n_pad % THREADS != 0) return (int)cudaErrorInvalidValue;
    if (n_pad <= 0 || l1 <= 0 || nseg <= 0) return 0;
    void* args[] = {&modes, &mask, &seg_i, &seg_f, &costm, &costmm, &codes_k, &lens_k,
                    &l1, &n_pad, &scratch, &out, &stamps};
    const dim3 grid(n_pad / THREADS, nseg);
    return (int)cudaLaunchKernel(fn, grid, dim3(THREADS), args, 0, (cudaStream_t)stream);
}

// Resources of kernel C (which = 0) or D (which = 1) at tile width tj:
// out[0..4] = registers a thread, static shared bytes a block, local
// (spill) bytes a thread, resident blocks an SM, threads a block.
extern "C" int sarlacc_score_attrs(int which, int tj, int* out)
{
    return kernel_attrs(kernel_for(which, tj), out);
}

#endif  // SCORE_BODY_ONLY
