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
// Two forms of one kernel: cross (rows a [TI, L] against rows b [TJ, L],
// pair p = i * TJ + j, out [TI, TJ]) and paired (index lists ia, ib [P]
// into one table, out [P]).  The DP runs down a's positions (rows) and
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

// Resources of route ``route`` (as sarlacc_lev2_kernel's): out[0..4] as
// csrc/walk_kernel.cu's sarlacc_walk_attrs.
extern "C" int sarlacc_lev2_attrs(int route, int* out)
{
    if (route == 0) return attrs(lev2_reg, out);
    return attrs(lev2_wide, out);
}
