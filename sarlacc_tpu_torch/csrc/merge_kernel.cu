// Kernel E: one wave of the MSA's profile merges, from the library entries
// to jmat, in one launch.
//
// Replaces sarlacc_tpu/ops/msa.py's chain ::_merge_cost_init (blank cost
// planes), ::_merge_accum_kernel (the library weights scatter-added in) and
// ::_merge_dp_walk (::_profile_merge_kernel, a lax.scan over the DP rows,
// then ::_merge_walk_kernel, a lax.scan back).  Plain PyTorch versions:
// sarlacc_tpu_torch/ops/msa.py::_merge_cost_init, ::_ordered_add_,
// ::_profile_merge_kernel and ::_merge_walk_kernel; jmat is bit-identical.
//
// Inputs: a wave's library entries, stable-sorted by their int64 key
// (m * rows + i - 1) * W + k (merge m, DP row i, band cell k; cell (i, j)
// sits at k = j - i - lo): each entry's band cell k (int32) and float32
// weight in that order, and int32 row pointers rowptr[m * rows + i - 1] ..
// rowptr[m * rows + i] that bound row i's entries (so a row's entries run
// in k order, and a cell's in entry order); la, lb, lo, kmax [Pp].  No
// cost plane exists: each live row's costs are built in shared memory (or,
// above 8 192 cells, in a row of device scratch) just before the row is
// computed.  A cell's cost is
// 0.0f plus its entries added one after another in entry order, the sum
// ((0 + w1) + w2) + ... that _ordered_add_ performs: the thread holding a
// run's first entry adds the run serially (no tree, no atomic).  A cell
// with no entry costs 0 when k <= kmax and NEG past kmax, as
// _merge_cost_init leaves it.  Per merge the gapless maximal-weight-trace
// DP
//   row 0:  S[k] = 0 where lo + k >= 0 and k <= kmax, else NEG;
//   row i:  M = S + (cost if 1 <= j <= lb else NEG)   (one float add)
//           S_up[k] = S[k + 1] (NEG at k = W - 1)
//           Sn = running max over k of max(M, S_up), over ALL W cells,
//                then NEG outside valid (0 <= j <= lb, k <= kmax)
//           choice = 0 if M >= Sn, else 2 if S_up >= Sn, else 1
// writes two bits a cell (sixteen cells a uint32 word, cell k at bits
// 2 * (k & 15) of word k >> 4) into a [rows, Pp, W / 16] scratch, for every
// cell of rows 1..min(la, rows): the walk's clamped lookups may read cells
// outside the band.  Rows past la and padded merges (la = 0) do no work.
// Then the walk: from row min(la, rows) down, at each row the first cell
// kf <= k (k clamped into [0, W - 1]) whose choice is not 1, found by a
// __ballot_sync over 32 cells at a time scanning downward; kf <= kz (j = 0)
// or kf < 0 ends the walk; choice 0 writes jmat[r - 1, p] = r + lo + kf
// (the wrapper zero-fills jmat) and moves to kf, choice 2 to kf + 1.  The
// walk reads its rows through windows: at a window's first row the warp
// copies 64 cells (four words) around the column of the next 32 rows into
// shared memory, a row a lane, so the chain of rows waits on device memory
// once a window; it copies again only when the column leaves the window
// (a lookup outside it reads device memory directly).
//
// Three routes, chosen by W in the wrapper (ops/cuda_walk.py::merge_route):
//
// Warp route (W 32-512, every bucket of the pipeline's usual bandwidth):
// one warp a merge, four merges a block, IT = W / 32 consecutive cells a
// lane, S in registers, the row's costs in the warp's W floats of shared
// memory, transposed (a lane's u-th cell at u * 32 + lane: a lane's IT
// consecutive floats at a 4 * IT-byte stride would be an IT-way bank
// conflict).  A lane takes S at its last cell + 1 from lane + 1
// (__shfl_down_sync); pass 1 keeps a running max of max(M, S_up) over its
// cells, a 5-step warp scan (exclusive by one more shuffle) completes the
// row's running max, and pass 2 recomputes M and S_up from the same
// registers and shared memory to give each cell's S and choice (holding
// M, S_up and the running max a cell would need 3 x IT more registers).
// The next row's row pointer and first 32 entries are loaded while this
// row computes.  At most 64 registers a thread, so 32 warps an SM.
//
// Block route (W 1 024-8 192): one block of 256 threads a merge, CT = W /
// 256 consecutive cells a thread in registers, the row's costs in shared
// memory, transposed as on the warp route and double-buffered by row (2 x
// W x 4 bytes: 64 KB at W 8 192); a
// thread's S_up across a warp boundary from the next warp's first S in
// shared memory, the row's running max a warp scan plus the earlier warps'
// maxima: two barriers a row.
//
// Wide route (W above 8 192, no upper limit: a profile's columns are not
// capped, so a merge of a long profile with a short one can give a band of
// 131 072 cells over a few rows): one block of 256 threads a merge, the
// row's cells in chunks of one cell a thread, S of the previous row and of
// this one and the row's costs in the merge's [3, W] slice of a float32
// device scratch; a chunk's running max is a warp scan plus the earlier
// warps' maxima from shared memory (double-buffered by chunk) plus the
// carry from the chunks before.
//
// On the block routes warp 0 walks after a block barrier.
//
// What bounds it: the DP's chain of rows, each a shuffle scan deep, and the
// walk's chain of rows, both per merge; a wave's merges run in parallel,
// and a wave holds tens to a few thousand.  Compulsory traffic: the kept
// entries (4-byte cell, 4-byte weight) and the row pointers once, jmat; ~6
// float operations a live cell and one add an entry.
//
// Exactness: max is exact, so the scan's order does not change any bit;
// the only arithmetic is the one add of M and the in-order entry sums.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1.0e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_BLOCK = 128;     // four merges a block on the warp route
constexpr int BLOCK_THREADS = 256;  // the block and wide routes' block
constexpr int NWARP = BLOCK_THREADS / 32;
constexpr int WIN_WORDS = 4;        // packed words (64 cells) of a walk window row

__device__ __forceinline__ int clamp_k(int k, int W)
{
    return k < 0 ? 0 : (k > W - 1 ? W - 1 : k);
}

__device__ __forceinline__ float blank(int k, int kmax)
{
    return k <= kmax ? 0.0f : NEG;
}

// Entry ``idx`` of the sorted table (or cell -1 past its end).
__device__ __forceinline__ void load_entry(const int32_t* __restrict__ cols,
                                           const float* __restrict__ wts, int n, int idx,
                                           int& col, float& w)
{
    col = -1;
    w = 0.0f;
    if (idx < n) {
        col = cols[idx];
        w = wts[idx];
    }
}

// If entry ``idx`` (< e, its row's end; cell ``col``, weight ``w``) opens
// its cell's run (its cell differs from ``prev``, the row's entry before's),
// sum the run from 0.0f in entry order and write the cell's cost.  A run
// may continue past this thread's chunk: the loop reads on to its end,
// four entries a step (the loads of a step overlap; the adds stay in entry
// order).  The row's costs are stored transposed, cell k of the thread
// owning cells [t * C, t * C + C) at (k % C) * T + k / C (T threads), so a
// thread's u-th cells of the T threads lie in consecutive banks.
template <int C, int T>
__device__ __forceinline__ void stage_run(const int32_t* __restrict__ cols,
                                          const float* __restrict__ wts, int idx, int e,
                                          int col, float w, int prev, float* cost)
{
    if (idx < e && col != prev) {
        float acc = 0.0f;
        acc += w;
        bool open = true;
        for (int q = idx + 1; open && q < e; q += 4) {
            int c[4];
            float v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                c[u] = q + u < e ? cols[q + u] : -1;
                v[u] = q + u < e ? wts[q + u] : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                open = open && c[u] == col;
                if (open) acc += v[u];
            }
        }
        cost[(col & (C - 1)) * T + col / C] = acc;
    }
}

// Two bits a cell for C consecutive cells starting at cell t * C: thread t's
// ``lo`` (cells 0-15) and ``hi`` (16-31) into ``row``'s words.  Below 16
// cells a thread, the 16 / C threads of a word (within one warp) merge
// their bits by shuffles and the first writes.
template <int C>
__device__ __forceinline__ void store_bits(uint32_t* row, uint32_t lo, uint32_t hi, int t)
{
    if constexpr (C == 32) {
        row[2 * t] = lo;
        row[2 * t + 1] = hi;
    } else if constexpr (C == 16) {
        row[t] = lo;
    } else {
        constexpr int L = 16 / C;
        lo <<= 2 * C * (t % L);
#pragma unroll
        for (int off = L / 2; off >= 1; off >>= 1) lo |= __shfl_xor_sync(FULL, lo, off);
        if (t % L == 0) row[t / L] = lo;
    }
}

// The choice of cell x of a walk row: from the window (cells wbase ..
// wbase + wc - 1, its words at ``wrow``) or from device memory (``grow``).
__device__ __forceinline__ int choice_at(const uint32_t* wrow, int wbase, int wc,
                                         const uint32_t* grow, int x)
{
    const int d = x - wbase;
    const uint32_t word = (unsigned)d < (unsigned)wc ? wrow[d >> 4] : grow[x >> 4];
    return (int)(word >> (2 * (x & 15))) & 3;
}

// One merge's walk by one whole warp over its packed choices; ``win`` is
// the warp's [32][WIN_WORDS] window.  ``choices`` is written earlier in the
// same launch, so it must not be read through the non-coherent read-only
// path (no const __restrict__ here).
__device__ void merge_walk(const uint32_t* choices, int Pp, int rows, int W, int p, int la,
                           int lb, int lo, int lane, uint32_t* win, int32_t* __restrict__ jmat)
{
    const int nword = W >> 4;
    const int ww = nword < WIN_WORDS ? nword : WIN_WORDS;
    const int wc = 16 * ww;  // cells of a window row
    // The walk enters at (la, lb) when la is a row, else at row ``rows``
    // with k = 0; with lb <= 0 no row is active.
    const int top = lb <= 0 ? 0 : (la < rows ? la : rows);
    int k = la <= rows ? lb - la - lo : 0;
    int wtop = 0, wbase = 0;  // the window's first row (0: none yet) and cell
    for (int r = top; r >= 1; --r) {
        if (r + lo + k <= 0) break;  // inactive now and below
        const int c = clamp_k(k, W);
        if ((unsigned)(wtop - r) >= 32u || (unsigned)(c - wbase) >= (unsigned)wc) {
            // The next 32 rows' words around c, row r - lane in slot lane.
            wtop = r;
            const int lowest = (c - 24) & ~15;
            wbase = lowest < 0 ? 0 : (lowest > W - wc ? W - wc : lowest);
            __syncwarp();  // every lane is done with the old window
            if (r - lane >= 1) {
                const uint32_t* src = choices + ((size_t)(r - lane - 1) * Pp + p) * nword + (wbase >> 4);
                for (int q = 0; q < ww; ++q) win[lane * WIN_WORDS + q] = src[q];
            }
            __syncwarp();
        }
        const uint32_t* wrow = win + (wtop - r) * WIN_WORDS;
        const uint32_t* grow = choices + ((size_t)(r - 1) * Pp + p) * nword;
        // The first k' <= c whose choice is not 1: lane l tests base - l.
        int kf = -1;
        for (int base = c; base >= 0; base -= 32) {
            const int idx = base - lane;
            const bool hit = idx >= 0 && choice_at(wrow, wbase, wc, grow, idx) != 1;
            const unsigned m = __ballot_sync(FULL, hit);
            if (m) {
                kf = base - (__ffs(m) - 1);
                break;
            }
        }
        if (kf <= -(r + lo) || kf < 0) break;  // died
        const int ch = choice_at(wrow, wbase, wc, grow, kf);
        if (ch == 0) {
            if (lane == 0) jmat[(size_t)(r - 1) * Pp + p] = r + lo + kf;
            k = kf;
        } else if (ch == 2) {
            k = kf + 1;
        }
    }
}

// The warp route: one warp a merge, IT = W / 32 cells a lane.
template <int IT>
__global__ void __launch_bounds__(WARP_BLOCK, 8) merge_warp_kernel(
    const int32_t* __restrict__ cols, const float* __restrict__ wts, int n,
    const int32_t* __restrict__ rowptr, int Pp, int rows,
    const int32_t* __restrict__ la_p, const int32_t* __restrict__ lb_p,
    const int32_t* __restrict__ lo_p, const int32_t* __restrict__ kmax_p,
    uint32_t* choices, int32_t* __restrict__ jmat)
{
    constexpr int W = 32 * IT;
    constexpr int NWORD = W / 16;
    __shared__ __align__(16) float sCost[WARP_BLOCK / 32][W];
    __shared__ uint32_t sWin[WARP_BLOCK / 32][32 * WIN_WORDS];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int p = blockIdx.x * (WARP_BLOCK / 32) + warp;
    if (p >= Pp) return;  // a whole warp
    const int la = la_p[p];
    const int lb = lb_p[p];
    const int lo = lo_p[p];
    const int kmax = kmax_p[p];
    const int k0 = lane * IT;
    const int top = la < rows ? la : rows;
    float* const cst = sCost[warp];

    float S[IT];
#pragma unroll
    for (int u = 0; u < IT; ++u) {
        const int k = k0 + u;
        cst[u * 32 + lane] = blank(k, kmax);  // transposed: see stage_run
        S[u] = (lo + k >= 0 && k <= kmax) ? 0.0f : NEG;
    }
    const int32_t* const rp = rowptr + (size_t)p * rows;
    int b = 0, e = 0, pk = -1;
    float pw = 0.0f;
    if (top >= 1) {
        b = rp[0];
        e = rp[1];
        load_entry(cols, wts, n, b + lane, pk, pw);
    }
    __syncwarp();

    for (int i = 1; i <= top; ++i) {
        // Row i's costs: its entries, 32 a step (the first step prefetched).
        int carry = -1;
        for (int base = b; base < e; base += 32) {
            int col = pk;
            float w = pw;
            if (base != b) load_entry(cols, wts, n, base + lane, col, w);
            int prev = __shfl_up_sync(FULL, col, 1);
            if (lane == 0) prev = carry;
            stage_run<IT, 32>(cols, wts, base + lane, e, col, w, prev, cst);
            carry = __shfl_sync(FULL, col, 31);
        }
        __syncwarp();
        // Row i + 1's bounds and first entries, in flight while row i computes.
        int ne = e;
        if (i < top) ne = rp[i + 1];
        load_entry(cols, wts, n, e + lane, pk, pw);

        float s_nb = __shfl_down_sync(FULL, S[0], 1);  // k0 + IT, row i - 1
        if (lane == 31) s_nb = NEG;  // k + 1 == W: outside the band
        const int jb = i + lo + k0;
        float tmax = NEG;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const int j = jb + u;
            const float M = S[u] + ((j >= 1 && j <= lb) ? cst[u * 32 + lane] : NEG);
            const float sup = u + 1 < IT ? S[u + 1] : s_nb;
            tmax = fmaxf(tmax, fmaxf(M, sup));
        }
        float x = tmax;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(FULL, x, off);
            if (lane >= off) x = fmaxf(x, y);
        }
        float run = __shfl_up_sync(FULL, x, 1);
        if (lane == 0) run = NEG;

        uint32_t bits = 0;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
            const int k = k0 + u;
            const int j = jb + u;
            const float M = S[u] + ((j >= 1 && j <= lb) ? cst[u * 32 + lane] : NEG);
            const float sup = u + 1 < IT ? S[u + 1] : s_nb;
            cst[u * 32 + lane] = blank(k, kmax);  // the next row's blank
            run = fmaxf(run, fmaxf(M, sup));
            const bool valid = j >= 0 && j <= lb && k <= kmax;
            const float sn = valid ? run : NEG;
            const uint32_t choice = (M >= sn) ? 0u : ((sup >= sn) ? 2u : 1u);
            bits |= choice << (2 * u);
            S[u] = sn;
        }
        store_bits<IT>(choices + ((size_t)(i - 1) * Pp + p) * NWORD, bits, 0u, lane);
        b = e;
        e = ne;
        __syncwarp();  // every lane's blanks are back before the next row's entries land
    }
    __syncwarp();  // the lanes' choice words visible to the whole warp
    merge_walk(choices, Pp, rows, W, p, la, lb, lo, lane, sWin[warp], jmat);
}

// The block route: one block a merge, CT = W / 256 cells a thread, the
// row's costs in shared memory (two rows, by row parity).
template <int CT>
__global__ void __launch_bounds__(BLOCK_THREADS) merge_block_kernel(
    const int32_t* __restrict__ cols, const float* __restrict__ wts, int n,
    const int32_t* __restrict__ rowptr, int Pp, int rows,
    const int32_t* __restrict__ la_p, const int32_t* __restrict__ lb_p,
    const int32_t* __restrict__ lo_p, const int32_t* __restrict__ kmax_p,
    uint32_t* choices, int32_t* __restrict__ jmat)
{
    constexpr int W = BLOCK_THREADS * CT;
    constexpr int NWORD = W / 16;
    extern __shared__ __align__(16) float sRows[];  // [2][W]
    __shared__ float sWarp[NWARP];    // each warp's running max of the row
    __shared__ float sFirst[NWARP];   // each warp's first S of the row before
    __shared__ uint32_t sWin[32 * WIN_WORDS];
    const int p = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int la = la_p[p];
    const int lb = lb_p[p];
    const int lo = lo_p[p];
    const int kmax = kmax_p[p];
    const int k0 = t * CT;
    const int top = la < rows ? la : rows;

    float S[CT];
#pragma unroll
    for (int u = 0; u < CT; ++u) {
        const int k = k0 + u;
        sRows[u * BLOCK_THREADS + t] = blank(k, kmax);  // transposed: see stage_run
        sRows[W + u * BLOCK_THREADS + t] = blank(k, kmax);
        S[u] = (lo + k >= 0 && k <= kmax) ? 0.0f : NEG;
    }
    if (lane == 0) sFirst[warp] = S[0];
    const int32_t* const rp = rowptr + (size_t)p * rows;
    int b = 0, e = 0;
    if (top >= 1) {
        b = rp[0];
        e = rp[1];
    }
    __syncthreads();

    for (int i = 1; i <= top; ++i) {
        float* const cst = sRows + (i & 1) * W;
        for (int base = b; base < e; base += BLOCK_THREADS) {
            const int idx = base + t;
            int col, prev = -1;
            float w;
            load_entry(cols, wts, n, idx, col, w);
            if (idx > b && idx - 1 < n) prev = cols[idx - 1];
            stage_run<CT, BLOCK_THREADS>(cols, wts, idx, e, col, w, prev, cst);
        }
        int ne = e;
        if (i < top) ne = rp[i + 1];
        __syncthreads();  // row i's costs staged; sFirst holds row i - 1's

        float s_nb = __shfl_down_sync(FULL, S[0], 1);
        if (lane == 31) s_nb = warp + 1 < NWARP ? sFirst[warp + 1] : NEG;
        const int jb = i + lo + k0;
        float tmax = NEG;
#pragma unroll
        for (int u = 0; u < CT; ++u) {
            const int j = jb + u;
            const float M = S[u] + ((j >= 1 && j <= lb) ? cst[u * BLOCK_THREADS + t] : NEG);
            const float sup = u + 1 < CT ? S[u + 1] : s_nb;
            tmax = fmaxf(tmax, fmaxf(M, sup));
        }
        float x = tmax;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(FULL, x, off);
            if (lane >= off) x = fmaxf(x, y);
        }
        if (lane == 31) sWarp[warp] = x;
        __syncthreads();  // every warp's maximum
        float run = __shfl_up_sync(FULL, x, 1);
        if (lane == 0) run = NEG;
        for (int w = 0; w < warp; ++w) run = fmaxf(run, sWarp[w]);

        uint32_t lo_bits = 0, hi_bits = 0;
#pragma unroll
        for (int u = 0; u < CT; ++u) {
            const int k = k0 + u;
            const int j = jb + u;
            const float M = S[u] + ((j >= 1 && j <= lb) ? cst[u * BLOCK_THREADS + t] : NEG);
            const float sup = u + 1 < CT ? S[u + 1] : s_nb;
            cst[u * BLOCK_THREADS + t] = blank(k, kmax);
            run = fmaxf(run, fmaxf(M, sup));
            const bool valid = j >= 0 && j <= lb && k <= kmax;
            const float sn = valid ? run : NEG;
            const uint32_t choice = (M >= sn) ? 0u : ((sup >= sn) ? 2u : 1u);
            if (u < 16) lo_bits |= choice << (2 * u);
            else hi_bits |= choice << (2 * (u - 16));
            S[u] = sn;
        }
        store_bits<CT>(choices + ((size_t)(i - 1) * Pp + p) * NWORD, lo_bits, hi_bits, t);
        if (lane == 0) sFirst[warp] = S[0];  // read after the next row's first barrier
        b = e;
        e = ne;
    }
    __syncthreads();  // every thread's choice words visible to warp 0
    if (warp == 0) merge_walk(choices, Pp, rows, W, p, la, lb, lo, lane, sWin, jmat);
}

// The wide route: one block a merge, chunks of 256 cells, S rows and the
// row's costs in ``scratch`` (the merge's [3, W] slice).
__global__ void __launch_bounds__(BLOCK_THREADS) merge_wide_kernel(
    const int32_t* __restrict__ cols, const float* __restrict__ wts, int n,
    const int32_t* __restrict__ rowptr, int Pp, int rows, int W,
    const int32_t* __restrict__ la_p, const int32_t* __restrict__ lb_p,
    const int32_t* __restrict__ lo_p, const int32_t* __restrict__ kmax_p,
    float* scratch, uint32_t* choices, int32_t* __restrict__ jmat)
{
    __shared__ float sWarp[2][NWARP];
    __shared__ uint32_t sWin[32 * WIN_WORDS];
    const int p = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nword = W >> 4;
    const int la = la_p[p];
    const int lb = lb_p[p];
    const int lo = lo_p[p];
    const int kmax = kmax_p[p];
    const int top = la < rows ? la : rows;
    float* const buf = scratch + (size_t)p * 3 * W;
    float* const cst = buf + 2 * (size_t)W;

    for (int k = t; k < W; k += BLOCK_THREADS) {
        buf[k] = (lo + k >= 0 && k <= kmax) ? 0.0f : NEG;
        cst[k] = blank(k, kmax);
    }
    const int32_t* const rp = rowptr + (size_t)p * rows;
    int b = 0, e = 0;
    if (top >= 1) {
        b = rp[0];
        e = rp[1];
    }
    __syncthreads();

    int par = 0;
    for (int i = 1; i <= top; ++i) {
        for (int base = b; base < e; base += BLOCK_THREADS) {
            const int idx = base + t;
            int col, prev = -1;
            float w;
            load_entry(cols, wts, n, idx, col, w);
            if (idx > b && idx - 1 < n) prev = cols[idx - 1];
            stage_run<1, BLOCK_THREADS>(cols, wts, idx, e, col, w, prev, cst);
        }
        int ne = e;
        if (i < top) ne = rp[i + 1];
        __syncthreads();  // row i's costs staged

        const float* cur = buf + (size_t)((i - 1) & 1) * W;  // row i - 1
        float* nxt = buf + (size_t)(i & 1) * W;              // row i
        uint32_t* drow = choices + ((size_t)(i - 1) * Pp + p) * nword;
        float carry = NEG;  // running max of the chunks before
        for (int c0 = 0; c0 < W; c0 += BLOCK_THREADS) {
            const int k = c0 + t;
            const int j = i + lo + k;
            const float cu = cst[k];
            cst[k] = blank(k, kmax);
            const float m = cur[k] + ((j >= 1 && j <= lb) ? cu : NEG);
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
            for (int w = 0; w < NWARP; ++w) {
                if (w < warp) pre = fmaxf(pre, sw[w]);
                total = fmaxf(total, sw[w]);
            }
            const bool valid = j >= 0 && j <= lb && k <= kmax;
            const float sn = valid ? fmaxf(pre, x) : NEG;
            nxt[k] = sn;
            const uint32_t choice = (m >= sn) ? 0u : ((sup >= sn) ? 2u : 1u);
            store_bits<1>(drow + (c0 >> 4), choice, 0u, t);
            carry = total;
        }
        b = e;
        e = ne;
        __syncthreads();  // row i complete before row i + 1 reads it
    }
    if (warp == 0) merge_walk(choices, Pp, rows, W, p, la, lb, lo, lane, sWin, jmat);
}

// The shared-memory block route's widths: 256 threads of 4-32 cells.
constexpr int BLOCK_MAX_WIDTH = BLOCK_THREADS * 32;

// The kernel of a route (0 warp, 1 block, 2 wide) at band width W, or
// null; the route's threads a block and dynamic shared bytes.
const void* kernel_for(int route, int W, int* threads, size_t* smem)
{
    *smem = 0;
    if (W < 32 || (W & (W - 1))) return nullptr;
    if (route == 0) {
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
    *threads = BLOCK_THREADS;
    if (route == 1) {
        *smem = 2 * (size_t)W * sizeof(float);
        switch (W) {
        case 1024: return (const void*)merge_block_kernel<4>;
        case 2048: return (const void*)merge_block_kernel<8>;
        case 4096: return (const void*)merge_block_kernel<16>;
        case 8192: return (const void*)merge_block_kernel<32>;
        default: return nullptr;
        }
    }
    if (route == 2 && W > BLOCK_MAX_WIDTH) return (const void*)merge_wide_kernel;
    return nullptr;
}

// Lets a block-route kernel take its dynamic shared memory above 48 KB.
cudaError_t allow_smem(const void* fn, size_t smem)
{
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// cols int32 [n], wts float32 [n] (entries past rowptr[Pp * rows] are
// never read), rowptr int32 [Pp * rows + 1]; la, lb, lo, kmax int32 [Pp]; choices uint32 [rows, Pp,
// W / 16] (scratch); jmat int32 [rows, Pp], zeroed by the caller.  route 0
// (warp): W a power of two from 32 to 512; 1 (block): 1 024-8 192; 2
// (wide): from 16 384 up, ``scratch`` float32 [Pp, 3, W].  Anything else is
// refused (cudaErrorInvalidValue).
extern "C" int sarlacc_merge_kernel(
    const int32_t* cols, const float* wts, int n, const int32_t* rowptr,
    int Pp, int rows, int W,
    const int32_t* la, const int32_t* lb, const int32_t* lo, const int32_t* kmax,
    int route, float* scratch, uint32_t* choices, int32_t* jmat, void* stream)
{
    int threads = 0;
    size_t smem = 0;
    const void* fn = kernel_for(route, W, &threads, &smem);
    if (!fn || rows < 0 || n < 0) return (int)cudaErrorInvalidValue;
    if (route == 2 && !scratch) return (int)cudaErrorInvalidValue;
    if (Pp <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t err = allow_smem(fn, smem);
    if (err != cudaSuccess) return (int)err;
    if (route == 2) {
        merge_wide_kernel<<<Pp, threads, 0, s>>>(
            cols, wts, n, rowptr, Pp, rows, W, la, lb, lo, kmax, scratch, choices, jmat);
    } else if (route == 1) {
        void* args[] = {(void*)&cols, (void*)&wts, (void*)&n, (void*)&rowptr, (void*)&Pp,
                        (void*)&rows, (void*)&la, (void*)&lb, (void*)&lo, (void*)&kmax,
                        (void*)&choices, (void*)&jmat};
        const cudaError_t e = cudaLaunchKernel(fn, dim3(Pp), dim3(threads), args, smem, s);
        if (e != cudaSuccess) return (int)e;
    } else {
        void* args[] = {(void*)&cols, (void*)&wts, (void*)&n, (void*)&rowptr, (void*)&Pp,
                        (void*)&rows, (void*)&la, (void*)&lb, (void*)&lo, (void*)&kmax,
                        (void*)&choices, (void*)&jmat};
        const int blocks = (Pp + WARP_BLOCK / 32 - 1) / (WARP_BLOCK / 32);
        const cudaError_t e = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, 0, s);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

// Resources of a route's kernel at band width W: out[0..4] = registers a
// thread, shared bytes a block (static and dynamic), local (spill) bytes a
// thread, resident blocks an SM, threads a block.
extern "C" int sarlacc_merge_attrs(int route, int W, int* out)
{
    int threads = 0;
    size_t smem = 0;
    const void* fn = kernel_for(route, W, &threads, &smem);
    if (!fn) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(fn, smem);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)(a.sharedSizeBytes + smem);
    out[2] = (int)a.localSizeBytes;
    out[3] = blocks;
    out[4] = threads;
    return 0;
}
