// Kernel A: quality-aware fitting/global affine-gap DP with run-length
// directions, for N reads against one IUPAC reference of R columns.
//
// Replaces sarlacc_tpu/ops/pallas_align.py::_dir_kernel (launched by
// _launch_dirs / fit_dirs_pallas).  Plain PyTorch version:
// sarlacc_tpu_torch/ops/align.py::dp_align; outputs are bit-identical.
//
// Work decomposition.  The reference's ordinary columns are cut into T =
// passes x G column tiles of near-equal width (at most TJ = 7, 15 or 31
// columns).  G lanes of one warp (G a power of two, 1 to 32) take one read:
// in pass p, lane g owns tile p*G + g.  Lanes are laid out tile-major: a
// warp holds span = 32 / G reads, lanes [g*span, (g+1)*span) run tile g of
// those reads, so each group's loads and direction stores cover span
// consecutive reads of one row (coalesced), and a hand-off is one
// __shfl_up_sync at distance span.  The grid is n_pad * G / 128 blocks of
// 128 threads.
//
// Wavefront.  Lane g computes row s - g at step s (rows outer, its tile's
// columns inner).  At the end of each step it hands the tile's last column
// at that row (S, H and, packed into one int, the left jump point and the
// left-step flag) to lane g + 1, which uses it one step later as its left
// boundary; the boundary S of the row above, the first column's diagonal,
// is the value it received the step before.  Lane 0 takes column 0 in pass
// 0 and, in later passes, reads the boundary that lane G - 1 of the
// previous pass wrote to a [3, l1, n_pad] scratch (one reference has one
// segment, so one slot; written and read in place, ordered by __syncwarp
// between passes).  A pass takes l1 + G - 1 steps.
//
// State.  Per tile column, in registers (fully unrolled power-of-two column
// blocks, as kernel C/D's Tile): the previous row's S, the running max of
// B over the rows above, and the vertical run's jump point packed with the
// next row's vertical-gap test (2 * pnt + test; the test needs this row's S,
// V and up flag, so it is done here and V and the up flag are never kept).
// Along the row: the left S, H, left-step flag and left jump point.  The
// fitting-mode last column (free trailing gaps, zero_vgap) is peeled off the
// tiles and run by the lane of the last tile.  No DP state is written to
// device memory but the pass hand-off; S goes out once a row, for the last
// column, from the last tile's lane.
//
// Costs per row.  As kernels C and D: a lane writes this row's costs for
// the slots its tile uses (its `need`) into its own column of a shared
// table, prefetched a row ahead, and a cell reads its cost at a byte offset
// staged per pass for (tile, code, column).
//
// What bounds it: instruction issue.  The compulsory traffic is the int16
// direction per cell and a code and 2-8 costs per row; a warp's direction
// store covers 32 / G reads of one row, a full 32-byte sector at G = 2 (so
// the wrapper keeps G at 2 where the reads fill the card) and a sector a
// lane at G = 32.  A cell compiles to ~60 instructions at tile 31 (~18
// float adds, maxes, compares and selects; the rest the run-length
// bookkeeping, register moves, two shared loads and the store), issued at
// about half the card's rate with 2-3 blocks an SM; so the kernel sits near
// a fifth of its byte bound at ~20 000 reads, and lower at 32 lanes a read,
// where each store touches 32 sectors (PERF.md section 6).
//
// Exactness: compile with --fmad=false.  The association (mv - go) + i*ge
// and cum - (i-1)*ge must not contract into FMAs, or the last bit moves
// and direction ties flip.  Tie rules follow reference_align.cpp:126-174: a
// gap jump wins only when strictly greater (cand >= jump keeps the open),
// is_diag and is_left are strict; row 0 is a single left step.  Every
// column's running max accumulates over rows in ascending order in the one
// lane that owns it, so the bits equal the column-outer order's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -3.0e38f;
constexpr int THREADS = 128;
constexpr int NCODE = 8;   // codes 0..7; 5 (padding) and above never match
constexpr int MAXG = 32;   // lanes a read at most
constexpr unsigned FULL = 0xffffffffu;

// Resident blocks an SM asked of the compiler at each tile width: the
// most that fit without spilling (asks of 5-8 spill at every width and run
// 10-60% slower, tools/dir_tiles.py's sweep on an H100); a build may set
// them (-DDIR_MIN_BLOCKS_7=... and so on), which that tool sweeps.
#ifndef DIR_MIN_BLOCKS_7
#define DIR_MIN_BLOCKS_7 4
#endif
#ifndef DIR_MIN_BLOCKS_15
#define DIR_MIN_BLOCKS_15 3
#endif
#ifndef DIR_MIN_BLOCKS_31
#define DIR_MIN_BLOCKS_31 3
#endif
constexpr int min_blocks(int top)
{
    return top >= 16 ? DIR_MIN_BLOCKS_31 : top >= 8 ? DIR_MIN_BLOCKS_15 : DIR_MIN_BLOCKS_7;
}

template <int TOP>
struct Shared {
    static constexpr int TJ = 2 * TOP - 1;
    static constexpr int KSTR = TJ + 2;  // TJ columns and the peeled one; odd
    int koff[MAXG][NCODE][KSTR];         // byte offset into tab: (tile of the pass, code, column)
    float tab[8][THREADS];               // this row's costs: slot m match, 4 + m mismatch
    int need[MAXG];                      // bit k: slot k is used by the tile
};

// One cell's values that the next column of the row reads.
struct Left {
    float s;    // S
    float h;    // H
    bool wl;    // the cell was a left step (or row 0)
    int ljp;    // the left run's jump point
};

// One ordinary cell at row i > 0 (dir_kernel's column-outer body, with the
// vertical test for row i + 1 done here).  diag: S of the left column at
// row i - 1; pS/cum/pu: this column's state; j: the column.
__device__ __forceinline__ void cell(
    float cost, float go, float ge, float rge, float rge1, int i, int j,
    Left& L, float& diag, float& pS, float& cum, int& pu, int16_t* d)
{
    const float M = diag + cost;
    const float cand_h = L.s - (L.wl ? ge : go);
    const float jump_h = L.h - ge;
    const bool cond_h = cand_h >= jump_h;
    const float Hn = cond_h ? cand_h : jump_h;
    const float mv = fmaxf(M, Hn);
    const float V = cum - rge1;
    const float B = (mv - go) + rge;
    const float Sn = fmaxf(mv, V);
    const bool is_diag = (M > Hn) && (M > V);
    const bool is_left = !is_diag && (Hn > V);
    const bool is_up = !(is_diag || is_left);
    L.ljp = cond_h ? j : L.ljp;
    const int pnt = (pu & 1) ? i : (pu >> 1);  // this row's test passed: the run restarts here
    *d = (int16_t)(is_diag ? 0 : (is_left ? (j + 1) - L.ljp : pnt - (i + 1)));
    const bool next_v = (Sn - (is_up ? ge : go)) >= (V - ge);
    pu = (pnt << 1) | (int)next_v;
    diag = pS;
    pS = Sn;
    cum = fmaxf(cum, B);
    L.s = Sn;
    L.h = Hn;
    L.wl = is_left;
}

// The same cell at row 0: V is NEG, S is H, the direction a single left
// step, the vertical test passes (pnt 0) and the cell counts as a left step.
__device__ __forceinline__ void cell0(
    float cost, float go, float ge, float rge, int j, Left& L, float& diag,
    float& pS, float& cum, int& pu, int16_t* d)
{
    const float M = diag + cost;
    const float cand_h = L.s - (L.wl ? ge : go);
    const float jump_h = L.h - ge;
    const bool cond_h = cand_h >= jump_h;
    const float Hn = cond_h ? cand_h : jump_h;
    const float mv = fmaxf(M, Hn);
    const float V = NEG;
    const float B = (mv - go) + rge;
    const bool is_diag = (M > Hn) && (M > V);
    const bool is_left = !is_diag && (Hn > V);
    const bool is_up = !(is_diag || is_left);
    L.ljp = cond_h ? j : L.ljp;
    *d = (int16_t)1;
    const bool next_v = (Hn - (is_up ? ge : go)) >= (V - ge);
    pu = (int)next_v;
    diag = pS;
    pS = Hn;
    cum = fmaxf(cum, B);
    L.s = Hn;
    L.h = Hn;
    L.wl = true;
}

// The register state of a tile's columns, in blocks of W, W/2, ..., 1
// columns (W a power of two).  A tile of tl columns runs the blocks whose
// bit is set in tl, widest first, each fully unrolled: no cell carries a
// bound check.
template <int W>
struct Tile {
    float pS[W];   // S at the previous row
    float cum[W];  // running max of B over the rows above
    int pu[W];     // 2 * (last row whose vertical gap did not jump) + next row's test
    Tile<W / 2> rest;

    __device__ __forceinline__ void init()
    {
#pragma unroll
        for (int jj = 0; jj < W; ++jj) {
            pS[jj] = NEG;
            cum[jj] = NEG;
            pu[jj] = 1;
        }
        rest.init();
    }

    // One row of the tile's ordinary columns (ROW0: row 0), from column j
    // on; d points at column j's direction at this row and moves a plane a
    // column.
    template <bool ROW0>
    __device__ __forceinline__ void row(
        int tl, const int* kr, const char* tab, float go, float ge, float rge, float rge1,
        int i, int& j, Left& L, float& diag, int16_t*& d, size_t plane)
    {
        if (tl & W) {
#pragma unroll
            for (int jj = 0; jj < W; ++jj) {
                const float cost = *reinterpret_cast<const float*>(tab + kr[jj]);
                if (ROW0)
                    cell0(cost, go, ge, rge, j, L, diag, pS[jj], cum[jj], pu[jj], d);
                else
                    cell(cost, go, ge, rge, rge1, i, j, L, diag, pS[jj], cum[jj], pu[jj], d);
                ++j;
                d += plane;
            }
            kr += W;
        }
        rest.template row<ROW0>(tl, kr, tab, go, ge, rge, rge1, i, j, L, diag, d, plane);
    }
};

template <>
struct Tile<0> {
    __device__ __forceinline__ void init() {}
    template <bool ROW0>
    __device__ __forceinline__ void row(
        int, const int*, const char*, float, float, float, float, int, int&, Left&,
        float&, int16_t*&, size_t) {}
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

// Tile t of T over rn ordinary columns: [first column, width).
__device__ __forceinline__ int tile_start(int t, int T, int rn)
{
    return (int)((long long)t * rn / T);
}

template <int TOP>
__global__ void __launch_bounds__(THREADS, min_blocks(TOP)) dir_kernel(
    const int32_t* __restrict__ modes, const int32_t* __restrict__ mask,
    int rlen, float go, float ge, int local,
    const float* __restrict__ costm, const float* __restrict__ costmm,
    const int32_t* __restrict__ codes_k, int l1, int n_pad, int G, int passes,
    float* scratch, float* __restrict__ S_out, int16_t* __restrict__ dirs,
    uint64_t* __restrict__ stamps)
{
    using Sh = Shared<TOP>;
    constexpr int TJ = Sh::TJ;
    constexpr int KSTR = Sh::KSTR;
    __shared__ Sh sh;
    const uint64_t t0 = stamps ? global_ns() : 0;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int span = 32 / G;          // reads a warp; the hand-off distance
    const int g = lane / span;        // this lane's tile in a pass
    const int n = blockIdx.x * (THREADS / G) + (tid >> 5) * span + (lane & (span - 1));
    const size_t plane = (size_t)l1 * n_pad;
    const bool peel = local && rlen > 0;  // last column: free trailing gaps
    const int rn = rlen - (peel ? 1 : 0);
    const int T = passes * G;
    const char* tab = reinterpret_cast<const char*>(&sh.tab[0][tid]);
    float* bS = scratch;  // pass hand-off: S, H, (ljp << 1 | wl) at each row
    float* bH = scratch ? scratch + plane : nullptr;
    int* bJ = scratch ? reinterpret_cast<int*>(scratch + 2 * plane) : nullptr;

    for (int p = 0; p < passes; ++p) {
        const int t = p * G + g;
        const int j0 = tile_start(t, T, rn);
        const int tl = tile_start(t + 1, T, rn) - j0;
        const bool last = t == T - 1;
        const bool zv = peel && last;

        // Stage the pass's (tile, code, column) -> table offsets: one
        // thread a (tile, code).
        __syncthreads();  // the previous pass is done with koff
        if (tid < MAXG) sh.need[tid] = 0;
        __syncthreads();
        for (int e = tid; e < G * NCODE; e += THREADS) {
            const int gg = e / NCODE, c = e % NCODE;
            const int tt = p * G + gg;
            const int a0 = tile_start(tt, T, rn);
            const int w = tile_start(tt + 1, T, rn) - a0;
            int bits = 0;
            for (int q = 0; q < w; ++q) {
                const int k = cost_slot(modes, mask, a0 + q, c);
                bits |= 1 << k;
                sh.koff[gg][c][q] = k * THREADS * (int)sizeof(float);
            }
            if (peel && tt == T - 1) {  // the peeled column goes to koff[.][c][TJ]
                const int k = cost_slot(modes, mask, rlen - 1, c);
                bits |= 1 << k;
                sh.koff[gg][c][TJ] = k * THREADS * (int)sizeof(float);
            }
            if (bits) atomicOr(&sh.need[gg], bits);
        }
        __syncthreads();
        const int need = sh.need[g];
        const int* koff = &sh.koff[g][0][0];

        Tile<TOP> cols;
        cols.init();
        float cumZ = NEG;  // the peeled column's running max
        int puZ = 1;       // and its run state
        float dL = NEG;    // S of the column left of the tile at the row above
        float rS = 0.0f, rH = 0.0f;  // lane g - 1's last column, from the last step
        int rJ = 0;

        int code_nx = codes_k[n];
        float v_nx[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            v_nx[k] = (need >> k) & 1 ? (k < 4 ? costm : costmm)[(k & 3) * plane + n] : 0.0f;

        for (int s = 0; s < l1 + G - 1; ++s) {
            const int i = s - g;
            float oS = 0.0f, oH = 0.0f;
            int oJ = 0;
            if (i >= 0 && i < l1) {
                const size_t at = (size_t)i * n_pad + n;
                const float fi = (float)i;
                const float rge = fi * ge;
                const float rge1 = (fi - 1.0f) * ge;

                Left L;
                if (g > 0) {
                    L = {rS, rH, (rJ & 1) != 0, rJ >> 1};
                } else if (p == 0) {  // column 0 (reference_align.cpp:65-74)
                    L = {(local || i == 0) ? 0.0f : (-go) - rge1, NEG, false, 0};
                } else {
                    const int x = bJ[at];
                    L = {bS[at], bH[at], (x & 1) != 0, x >> 1};
                }
                float diag = dL;
                dL = L.s;

                const int* kr = koff + min((unsigned)code_nx, (unsigned)NCODE - 1) * KSTR;
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    if ((need >> k) & 1) sh.tab[k][tid] = v_nx[k];
                if (i + 1 < l1) {  // prefetch row i + 1
                    const size_t nx = at + n_pad;
                    code_nx = codes_k[nx];
#pragma unroll
                    for (int k = 0; k < 8; ++k)
                        if ((need >> k) & 1) v_nx[k] = (k < 4 ? costm : costmm)[(k & 3) * plane + nx];
                }

                int j = j0;
                int16_t* d = dirs + ((size_t)j0 * l1 + i) * n_pad + n;
                if (i == 0)
                    cols.template row<true>(tl, kr, tab, go, ge, rge, rge1, i, j, L, diag, d, plane);
                else
                    cols.template row<false>(tl, kr, tab, go, ge, rge, rge1, i, j, L, diag, d, plane);
                if (zv) {  // the peeled last column: V carries no ramp, B = mv
                    const float cost = *reinterpret_cast<const float*>(tab + kr[TJ]);
                    const float M = diag + cost;
                    const float cand_h = L.s - (L.wl ? ge : go);
                    const float jump_h = L.h - ge;
                    const bool cond_h = cand_h >= jump_h;
                    const float Hn = cond_h ? cand_h : jump_h;
                    const float mv = fmaxf(M, Hn);
                    const float V = i > 0 ? cumZ : NEG;
                    const float Sn = i > 0 ? fmaxf(mv, V) : Hn;
                    const bool is_diag = (M > Hn) && (M > V);
                    const bool is_left = !is_diag && (Hn > V);
                    L.ljp = cond_h ? j : L.ljp;
                    const int pnt = (puZ & 1) ? i : (puZ >> 1);  // row 0: puZ = 1
                    *d = (int16_t)(i == 0 ? 1 : is_diag ? 0 : (is_left ? (j + 1) - L.ljp : pnt - (i + 1)));
                    const bool next_v = (Sn - 0.0f) >= (V - 0.0f);  // vgo = vge = 0
                    puZ = (pnt << 1) | (int)next_v;
                    cumZ = fmaxf(cumZ, mv);
                    L.s = Sn;
                    L.h = Hn;
                    L.wl = i == 0 || is_left;
                }
                if (last) {
                    S_out[at] = L.s;
                } else if (g == G - 1) {  // hand the pass's last column to the next pass
                    bS[at] = L.s;
                    bH[at] = L.h;
                    bJ[at] = (L.ljp << 1) | (int)L.wl;
                }
                oS = L.s;
                oH = L.h;
                oJ = (L.ljp << 1) | (int)L.wl;
            }
            if (G > 1) {  // G is a kernel argument: the same for every lane
                rS = __shfl_up_sync(FULL, oS, span);
                rH = __shfl_up_sync(FULL, oH, span);
                rJ = __shfl_up_sync(FULL, oJ, span);
            }
        }
        __syncwarp();  // lane G - 1's scratch rows, before lane 0 reads them
    }

    if (stamps) {  // a kernel argument: the same for every thread
        __syncthreads();
        if (tid == 0) {
            unsigned smid;
            asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
            stamps[3 * blockIdx.x] = t0;
            stamps[3 * blockIdx.x + 1] = global_ns();
            stamps[3 * blockIdx.x + 2] = smid;
        }
    }
}

// The instantiation of tile width tj (7, 15 or 31), or null.
const void* kernel_for(int tj)
{
    switch (tj) {
    case 7: return (const void*)dir_kernel<4>;
    case 15: return (const void*)dir_kernel<8>;
    case 31: return (const void*)dir_kernel<16>;
    default: return nullptr;
    }
}

}  // namespace

// Returns a CUDA error code (0 on success).  tj: 7, 15 or 31; G: a power
// of two from 1 to 32 that divides the warp's reads evenly into n_pad
// (n_pad * G a multiple of 128); passes * G tiles of at most tj columns
// must cover the ordinary columns; scratch ([3, l1, n_pad] f32) is needed
// only when passes > 1.  stamps (measurement only, else null): per block
// {start ns, end ns, SM id}, n_pad * G / 128 blocks.
extern "C" int sarlacc_dir_kernel(
    const int32_t* modes, const int32_t* mask, int rlen, float go, float ge,
    int local, const float* costm, const float* costmm, const int32_t* codes_k,
    int l1, int n_pad, int tj, int G, int passes, float* scratch, float* S_out,
    int16_t* dirs, uint64_t* stamps, void* stream)
{
    const void* fn = kernel_for(tj);
    const int rn = rlen - (local && rlen > 0 ? 1 : 0);
    if (!fn || G < 1 || G > MAXG || (G & (G - 1)) || passes < 1 || rlen < 0)
        return (int)cudaErrorInvalidValue;
    if (((long long)n_pad * G) % THREADS != 0 || (long long)passes * G * tj < rn)
        return (int)cudaErrorInvalidValue;
    if (passes > 1 && !scratch) return (int)cudaErrorInvalidValue;
    if (n_pad <= 0 || l1 <= 0) return 0;
    void* args[] = {&modes, &mask, &rlen, &go, &ge, &local, &costm, &costmm, &codes_k,
                    &l1, &n_pad, &G, &passes, &scratch, &S_out, &dirs, &stamps};
    const dim3 grid((unsigned)((long long)n_pad * G / THREADS));
    return (int)cudaLaunchKernel(fn, grid, dim3(THREADS), args, 0, (cudaStream_t)stream);
}

// Resources of kernel A at tile width tj: out[0..4] = registers a thread,
// static shared bytes a block, local (spill) bytes a thread, resident
// blocks an SM, threads a block.
extern "C" int sarlacc_dir_attrs(int tj, int* out)
{
    const void* fn = kernel_for(tj);
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
