// Kernel I: doubled Levenshtein distances for UMI grouping, one thread a
// pair (match 0, N = code 4 against anything 1, mismatch or indel 2; pad
// code 5).
//
// Replaces sarlacc_tpu/ops/levenshtein.py::_lev2_tile_kernel (:139, via
// _tile_d2 :84) and the tile DP of ::_lev2_rowblock_sparse (:249), each a
// jitted lax.scan over the columns of b with the pairs on lanes.  Plain
// PyTorch version: sarlacc_tpu_torch/ops/levenshtein.py::_lev2_scan; the
// distances are bit-identical.
//
// Three forms: cross (rows a [TI, L] against rows b [TJ, L], pair p = i *
// TJ + j, out [TI, TJ]) and paired (index lists ia, ib [P] into one table,
// out [P]) compute whole distances (lev2_matrix, lev2_condensed); the
// thresholded form (sarlacc_lev2_hits, below) decides d2 <= thr for the
// pairs of one row-block scan and writes only the hits.  The DP runs down a's positions (rows) and
// across b's (columns): col[0] = 2 (jx + 1), col[r] = min(prev[r] + 2,
// prev[r - 1] + ms, col[r - 1] + 2), the answer col[la] after column lb;
// lb == 0 (or lb > L, a column the plain scan never reaches) answers 2 la.
//
// What bounds it: operations.  A cell is two adds, two minimums, a select
// of its substitution cost and the cost's bits: ~6 integer operations, and
// nothing of it leaves the thread.  The register route (L <= 32) keeps the
// whole column in registers, unrolled over a compile-time height of 32
// rows, with a's codes as one bit mask a code value (ms = 2 - 2 eq - n
// from the bits of a row), so a column costs no memory access but b's
// code.  Above 32 positions the column lives in a device scratch laid out
// [L + 1][threads] (coalesced, L1-resident) and the rows run to la only;
// no width is refused.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LEV_THREADS = 128;
constexpr int REG_ROWS = 32;  // the register route's column height

__device__ __forceinline__ void pair_of(long long p, int TJ, const int64_t* ia,
                                        const int64_t* ib, long long& i, long long& j)
{
    if (ia) {
        i = ia[p];
        j = ib[p];
    } else {
        i = p / TJ;
        j = p - i * TJ;
    }
}

__global__ void __launch_bounds__(LEV_THREADS) lev2_reg(
    const int32_t* __restrict__ a, const int32_t* __restrict__ la_p,
    const int32_t* __restrict__ b, const int32_t* __restrict__ lb_p,
    const int64_t* __restrict__ ia, const int64_t* __restrict__ ib,
    int TJ, long long P, int L, int32_t* __restrict__ out)
{
    const long long p = (long long)blockIdx.x * LEV_THREADS + threadIdx.x;
    if (p >= P) return;
    long long i, j;
    pair_of(p, TJ, ia, ib, i, j);
    const int la = la_p[i], lb = lb_p[j];
    if (lb <= 0 || lb > L) {
        out[p] = 2 * la;
        return;
    }
    // One mask a code value: bit r - 1 set where a's position r holds it.
    uint32_t eq[6] = {0, 0, 0, 0, 0, 0};
    const int32_t* ar = a + i * L;
#pragma unroll
    for (int r = 0; r < REG_ROWS; ++r) {
        const int c = r < L ? ar[r] : 5;
#pragma unroll
        for (int v = 0; v < 6; ++v) eq[v] |= (uint32_t)(c == v) << r;
    }
    int col[REG_ROWS + 1];
#pragma unroll
    for (int r = 0; r <= REG_ROWS; ++r) col[r] = 2 * r;
    const int32_t* br = b + j * L;
    for (int jx = 0; jx < lb; ++jx) {
        const int c = br[jx];
        uint32_t eqc = 0, nc = eq[4];
#pragma unroll
        for (int v = 0; v < 6; ++v) eqc = c == v ? eq[v] : eqc;
        if (c == 4) {
            eqc = 0;
            nc = ~0u;
        }
        int diag = col[0];
        col[0] = 2 * (jx + 1);
#pragma unroll
        for (int r = 1; r <= REG_ROWS; ++r) {
            const int ms = 2 - 2 * (int)((eqc >> (r - 1)) & 1) - (int)((nc >> (r - 1)) & 1);
            const int old = col[r];
            const int v = min(old + 2, diag + ms);
            col[r] = min(v, col[r - 1] + 2);
            diag = old;
        }
    }
    int ans = 2 * la;
#pragma unroll
    for (int r = 0; r <= REG_ROWS; ++r) ans = r == la ? col[r] : ans;
    out[p] = ans;
}

// The column in scratch[r * threads + t], rows 0 .. min(la, L) only.
__global__ void __launch_bounds__(LEV_THREADS) lev2_wide(
    const int32_t* __restrict__ a, const int32_t* __restrict__ la_p,
    const int32_t* __restrict__ b, const int32_t* __restrict__ lb_p,
    const int64_t* __restrict__ ia, const int64_t* __restrict__ ib,
    int TJ, long long P, int L, int32_t* __restrict__ scratch, int32_t* __restrict__ out)
{
    const long long threads = (long long)gridDim.x * LEV_THREADS;
    const long long t = (long long)blockIdx.x * LEV_THREADS + threadIdx.x;
    int32_t* colp = scratch + t;
    for (long long p = t; p < P; p += threads) {
        long long i, j;
        pair_of(p, TJ, ia, ib, i, j);
        const int la = la_p[i], lb = lb_p[j];
        if (lb <= 0 || lb > L) {
            out[p] = 2 * la;
            continue;
        }
        const int rows = la < L ? (la > 0 ? la : 0) : L;
        const int32_t* ar = a + i * L;
        const int32_t* br = b + j * L;
        for (int r = 0; r <= rows; ++r) colp[r * threads] = 2 * r;
        int left = 0;
        for (int jx = 0; jx < lb; ++jx) {
            const int c = br[jx];
            int diag = colp[0];
            left = 2 * (jx + 1);
            colp[0] = left;
            for (int r = 1; r <= rows; ++r) {
                const int ac = ar[r - 1];
                const int ms = (c == 4 || ac == 4) ? 1 : (ac == c ? 0 : 2);
                const int old = colp[r * threads];
                left = min(min(old + 2, diag + ms), left + 2);
                colp[r * threads] = left;
                diag = old;
            }
        }
        out[p] = left;
    }
}

// ---------------------------------------------------------------------------
// The thresholded form: the whole row-block scan of one
// ops/levenshtein.py::_neighbor_pairs_rowblock call, replacing the tile DP
// of sarlacc_tpu/ops/levenshtein.py::_lev2_rowblock_sparse (:249) and the
// caller's [TI, TJ] distance matrix, threshold mask and torch.nonzero.
//
// The rows are sorted by length; a job is (r0, r1, c0, c1): rows [r0, r1)
// (one thread a row, at most HIT_THREADS) against columns [c0, c1) (at most
// HIT_COLS), and a pair is scanned when j >= i.  Only the band of the DP
// with 2 |r - c| <= thr is kept, H = thr / 2 cells each side of the
// diagonal: any path through a cell off the band already costs more than
// thr (each step off the diagonal is an indel, 2 doubled units; N costs 1
// and a mismatch 2, on the diagonal), so a band cell whose true value is
// at most thr has it, and every other band cell stays above thr.  A pair
// with 2 |la - lb| > thr is skipped outright; a pair stops as soon as every
// band cell of a column exceeds thr (costs never fall).  The verdict d2 <=
// thr is exact, and so is the distance of every hit.
//
// Band cell k of column c is row r = c + k - H: new[k] = min(old[k + 1] +
// 2 (left), old[k] + ms (diagonal), new[k - 1] + 2 (up)), row 0 = 2 c,
// rows below 0 or past la out of the band.  The register route (W <= 64,
// H <= 15) keeps a's codes as one 64-bit mask a code value (ms = 2 - 2 eq
// - n, the band's bits by one shift a column) and the band in registers,
// unrolled over its compile-time width, with b's rows for the job's column
// tile staged in shared memory (every thread reads the same b: a
// broadcast).  Wider bands or rows take the scratch route: the band in a
// device scratch [BW][threads], a's and b's codes read from the table.
//
// Output: each hit's key i * n + j appended by a warp-aggregated atomic
// (one atomicAdd a warp and column); the count stays exact past ``cap``,
// so a caller can re-run with a buffer of that size.  ``cells`` (optional)
// counts the DP cells evaluated, to each pair's exit: the band cells of a
// column with 1 <= r <= la (the row-0 boundary and the rows off the matrix
// are set, not computed; see matrix_cells).
//
// What bounds it: operations, ~6 integer operations a band cell (two adds,
// two minimums, the cost from two mask bits) on the cells the count gives;
// bytes are the codes once and 8 a hit.

constexpr int HIT_THREADS = 128;
constexpr int HIT_COLS = 256;     // columns a job
constexpr int HIT_REG_W = 64;     // the register route's widest row
constexpr int HIT_REG_H = 15;     // and its widest half-band
constexpr int INF = 1 << 20;

__device__ __forceinline__ void append_hit(bool hit, long long key,
                                           long long* __restrict__ hits, long long cap,
                                           unsigned long long* __restrict__ count)
{
    const unsigned FULLM = 0xffffffffu;
    const unsigned m = __ballot_sync(FULLM, hit);
    if (!m) return;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(m) - 1;
    unsigned long long base = 0;
    if (lane == leader) base = atomicAdd(count, (unsigned long long)__popc(m));
    base = __shfl_sync(FULLM, base, leader);
    if (hit) {
        const unsigned long long at = base + __popc(m & ((1u << lane) - 1u));
        if (at < (unsigned long long)cap) hits[at] = key;
    }
}

// The DP cells of band column c (rows c - H .. c + H) inside the matrix:
// 1 <= r <= la.
__device__ __forceinline__ int matrix_cells(int c, int H, int la)
{
    return max(0, min(c + H, la) - max(c - H, 1) + 1);
}

__device__ __forceinline__ void add_cells(unsigned long long mine,
                                          unsigned long long* __restrict__ cells)
{
    if (!cells) return;
    for (int d = 16; d > 0; d >>= 1) mine += __shfl_down_sync(0xffffffffu, mine, d);
    if ((threadIdx.x & 31) == 0 && mine) atomicAdd(cells, mine);
}

template <int H>
__global__ void __launch_bounds__(HIT_THREADS) lev2_hits_reg(
    const int8_t* __restrict__ codes, const int32_t* __restrict__ lens, int W, long long n,
    int thr, const int4* __restrict__ jobs, int n_jobs, long long* __restrict__ hits,
    long long cap, unsigned long long* __restrict__ count, unsigned long long* __restrict__ cells)
{
    constexpr int BW = 2 * H + 1;
    __shared__ int8_t sb[HIT_COLS * HIT_REG_W];
    __shared__ int slb[HIT_COLS];
    unsigned long long my_cells = 0;
    for (int job = blockIdx.x; job < n_jobs; job += gridDim.x) {
        const int4 jb = jobs[job];
        const int ncols = jb.w - jb.z;
        for (int t = threadIdx.x; t < ncols * W; t += HIT_THREADS)
            sb[t] = codes[(long long)jb.z * W + t];
        for (int t = threadIdx.x; t < ncols; t += HIT_THREADS) slb[t] = lens[jb.z + t];
        __syncthreads();

        const long long i = (long long)jb.x + threadIdx.x;
        const bool row = i < jb.y;
        const int la = row ? lens[i] : 0;
        // One mask a code value: bit r - 1 set where a's position r holds it.
        unsigned long long eq[6] = {0, 0, 0, 0, 0, 0};
        if (row) {
            const int8_t* ar = codes + i * W;
            for (int r = 0; r < W; ++r) {
                const int c = ar[r];
#pragma unroll
                for (int v = 0; v < 6; ++v) eq[v] |= (unsigned long long)(c == v) << r;
            }
        }
        for (int jj = 0; jj < ncols; ++jj) {
            const long long j = (long long)jb.z + jj;
            const int lb = slb[jj];
            bool hit = false;
            if (row && j >= i && abs(la - lb) <= H) {
                int band[BW + 1];  // band[BW] stays out of the band
#pragma unroll
                for (int k = 0; k <= BW; ++k) {
                    const int r = k - H;
                    band[k] = (k < BW && r >= 0 && r <= la) ? 2 * r : INF;
                }
                const int8_t* br = sb + jj * W;
                bool dead = false;
                for (int c = 1; c <= lb; ++c) {
                    const int bc = br[c - 1];
                    unsigned long long eqc = 0, nc = eq[4];
#pragma unroll
                    for (int v = 0; v < 6; ++v) eqc = bc == v ? eq[v] : eqc;
                    if (bc == 4) {
                        eqc = 0;
                        nc = ~0ull;
                    }
                    const int sh = c - H - 1;  // band cell k reads bit sh + k
                    const unsigned long long we = sh >= 0 ? eqc >> sh : eqc << -sh;
                    const unsigned long long wn = sh >= 0 ? nc >> sh : nc << -sh;
                    int up = INF, low = INF;
#pragma unroll
                    for (int k = 0; k < BW; ++k) {
                        const int r = c - H + k;
                        const int left = band[k + 1];
                        const int ms = 2 - 2 * (int)((we >> k) & 1ull) - (int)((wn >> k) & 1ull);
                        int v = min(min(left + 2, band[k] + ms), up + 2);
                        if (r == 0) v = 2 * c;
                        if (r < 0 || r > la) v = INF;
                        band[k] = v;
                        up = v;
                        low = min(low, v);
                    }
                    my_cells += matrix_cells(c, H, la);
                    if (low > thr) {
                        dead = true;
                        break;
                    }
                }
                if (!dead) {
                    const int at = la - lb + H;
                    int d = INF;
#pragma unroll
                    for (int k = 0; k < BW; ++k) d = k == at ? band[k] : d;
                    hit = d <= thr;
                }
            }
            append_hit(hit, i * n + j, hits, cap, count);
        }
        __syncthreads();  // sb and slb are restaged by the next job
    }
    add_cells(my_cells, cells);
}

// The scratch route: the band in scratch[k * threads + t], any row width
// and half-band.
__global__ void __launch_bounds__(HIT_THREADS) lev2_hits_wide(
    const int8_t* __restrict__ codes, const int32_t* __restrict__ lens, int W, long long n,
    int thr, const int4* __restrict__ jobs, int n_jobs, long long* __restrict__ hits,
    long long cap, unsigned long long* __restrict__ count, unsigned long long* __restrict__ cells,
    int32_t* __restrict__ scratch)
{
    const int H = thr >> 1, BW = 2 * H + 1;
    const long long threads = (long long)gridDim.x * HIT_THREADS;
    int32_t* band = scratch + (long long)blockIdx.x * HIT_THREADS + threadIdx.x;
    unsigned long long my_cells = 0;
    for (int job = blockIdx.x; job < n_jobs; job += gridDim.x) {
        const int4 jb = jobs[job];
        const long long i = (long long)jb.x + threadIdx.x;
        const bool row = i < jb.y;
        const int la = row ? lens[i] : 0;
        const int8_t* ar = codes + (row ? i : 0) * W;
        for (long long j = jb.z; j < jb.w; ++j) {
            const int lb = lens[j];
            bool hit = false;
            if (row && j >= i && abs(la - lb) <= H) {
                for (int k = 0; k < BW; ++k) {
                    const int r = k - H;
                    band[k * threads] = (r >= 0 && r <= la) ? 2 * r : INF;
                }
                const int8_t* br = codes + j * W;
                bool dead = false;
                for (int c = 1; c <= lb; ++c) {
                    const int bc = br[c - 1];
                    int up = INF, low = INF;
                    for (int k = 0; k < BW; ++k) {
                        const int r = c - H + k;
                        int v = INF;
                        if (r == 0) {
                            v = 2 * c;
                        } else if (r > 0 && r <= la) {
                            const int ac = ar[r - 1];
                            const int ms = (bc == 4 || ac == 4) ? 1 : (ac == bc ? 0 : 2);
                            const int left = k + 1 < BW ? band[(k + 1) * threads] : INF;
                            v = min(min(left + 2, band[k * threads] + ms), up + 2);
                        }
                        band[k * threads] = v;
                        up = v;
                        low = min(low, v);
                    }
                    my_cells += matrix_cells(c, H, la);
                    if (low > thr) {
                        dead = true;
                        break;
                    }
                }
                hit = !dead && band[(la - lb + H) * threads] <= thr;
            }
            append_hit(hit, i * n + j, hits, cap, count);
        }
    }
    add_cells(my_cells, cells);
}

template <int H>
int launch_reg(const int8_t* codes, const int32_t* lens, int W, long long n, int thr,
               const int4* jobs, int n_jobs, long long* hits, long long cap,
               unsigned long long* count, unsigned long long* cells, cudaStream_t st)
{
    lev2_hits_reg<H><<<n_jobs, HIT_THREADS, 0, st>>>(codes, lens, W, n, thr, jobs, n_jobs, hits,
                                                     cap, count, cells);
    return 0;
}

template <int... Hs>
int dispatch_reg(int H, const int8_t* codes, const int32_t* lens, int W, long long n, int thr,
                 const int4* jobs, int n_jobs, long long* hits, long long cap,
                 unsigned long long* count, unsigned long long* cells, cudaStream_t st)
{
    int done = 0;
    ((H == Hs ? (launch_reg<Hs>(codes, lens, W, n, thr, jobs, n_jobs, hits, cap, count, cells,
                                st), done = 1) : 0), ...);
    return done;
}

template <typename K>
int attrs(K kernel, int* out)
{
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, LEV_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = (int)a.localSizeBytes;
    out[3] = blocks;
    out[4] = LEV_THREADS;
    return 0;
}

}  // namespace

// a int32 [*, L] with la int32; b int32 [*, L] with lb int32; cross form
// (ia == ib == NULL): pair p = i * TJ + j; paired form: ia, ib int64 [P]
// into a and b (the same table).  out int32 [P].  route 0: registers (L <=
// 32), 1: the scratch route, with scratch int32 [(L + 1) * threads] for
// ``threads`` = blocks * 128 resident pairs.
extern "C" int sarlacc_lev2_kernel(
    const int32_t* a, const int32_t* la, const int32_t* b, const int32_t* lb,
    const int64_t* ia, const int64_t* ib, int TJ, long long P, int L, int route,
    int32_t* scratch, int blocks, int32_t* out, void* stream)
{
    if (P < 0 || L < 0 || (!ia && TJ < 1)) return (int)cudaErrorInvalidValue;
    if (P == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const long long grid = (P + LEV_THREADS - 1) / LEV_THREADS;
    if (route == 0 && L <= REG_ROWS) {
        lev2_reg<<<(unsigned)grid, LEV_THREADS, 0, st>>>(a, la, b, lb, ia, ib, TJ, P, L, out);
    } else if (route == 1 && scratch && blocks >= 1) {
        lev2_wide<<<blocks, LEV_THREADS, 0, st>>>(a, la, b, lb, ia, ib, TJ, P, L, scratch, out);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Resources of route ``route`` (0 and 1 as sarlacc_lev2_kernel's; 2 the
// thresholded register route at half-band 2, 3 its scratch route): out[0..4]
// as csrc/walk_kernel.cu's sarlacc_walk_attrs.
extern "C" int sarlacc_lev2_attrs(int route, int* out)
{
    if (route == 0) return attrs(lev2_reg, out);
    if (route == 1) return attrs(lev2_wide, out);
    if (route == 2) return attrs(lev2_hits_reg<2>, out);  // the long-UMI workloads' half-band
    return attrs(lev2_hits_wide, out);
}

// The thresholded form: codes int8 [n, W] sorted by length with lens int32
// [n]; jobs int32 [n_jobs, 4] (r0, r1, c0, c1), r1 - r0 <= 128, c1 - c0 <=
// 256; hits int64 [cap] get keys i * n + j, count (uint64 [1], zeroed by the
// caller) the exact number of hits, cells (uint64 [1] or NULL) the band
// cells evaluated.  route 0: registers (W <= 64, thr / 2 <= 15); 1: the
// scratch route, scratch int32 [(2 (thr / 2) + 1) * blocks * 128].
extern "C" int sarlacc_lev2_hits(
    const int8_t* codes, const int32_t* lens, int W, long long n, int thr, const int32_t* jobs,
    int n_jobs, long long* hits, long long cap, unsigned long long* count,
    unsigned long long* cells, int route, int32_t* scratch, int blocks, void* stream)
{
    if (n < 0 || W < 0 || thr < 0 || n_jobs < 0 || cap < 0) return (int)cudaErrorInvalidValue;
    if (n_jobs == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int4* jb = reinterpret_cast<const int4*>(jobs);
    const int H = thr >> 1;
    if (route == 0 && W <= HIT_REG_W && H <= HIT_REG_H) {
        if (!dispatch_reg<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15>(
                H, codes, lens, W, n, thr, jb, n_jobs, hits, cap, count, cells, st))
            return (int)cudaErrorInvalidValue;
    } else if (route == 1 && scratch && blocks >= 1) {
        lev2_hits_wide<<<blocks, HIT_THREADS, 0, st>>>(codes, lens, W, n, thr, jb, n_jobs, hits,
                                                       cap, count, cells, scratch);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
