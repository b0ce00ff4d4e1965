// Kernel G: the template backtrack over kernel A's run-length directions,
// to query maps (qmap) or to gapped-alignment emissions (string).
//
// Replaces sarlacc_tpu/ops/backtrack.py::qmap_walk_device (:77) and
// ::string_walk_device (:167) in their plane layout, each a jitted
// lax.while_loop of 8-step fori_loops over every read at once.  Plain
// PyTorch versions: sarlacc_tpu_torch/ops/backtrack.py::_qmap_walk_plain
// and ::_string_walk_plain; the outputs are bit-identical.
//
// Input: the int16 direction plane [R, l1, n_pad] kernel A writes (cell
// (c, r) of read n at (c * l1 + r) * n_pad + n: 0 diagonal, +k a left run,
// -k an up run) and the int32 lengths of the first nlen reads; lanes past
// nlen walk from row 0, as the plain versions' zero-padded lengths do.
//
// One thread a read walks its backtrack to the end in one launch, with no
// host sync: a lane's step is the plain loop's step for that lane, and a
// finished lane is a no-op there, so the lane stops when it finishes or at
// the plain loop's step cap, which counts whole blocks of 8 steps below
// R + l1 + 4 (qmap) or T + 8 (string, T = R + l1 + 1), so a malformed
// plane stops where the plain loop stops.  Every fetch clamps its flat
// index into [0, R * l1 - 1], as the plain gather does.
//
// What bounds it: latency.  Each step's fetch depends on the row and
// column the step before resolved, so a read is a chain of dependent loads
// (the plane is ten times the L2 at the pipeline's shape).  The design:
//
// * The fitting column in slabs (qmap).  A fitting walk starts by climbing
//   the last column one up step at a time (three quarters of its fetches
//   at the pipeline's shape).  That column is contiguous across a warp's
//   32 reads, so the warp loads SLAB_ROWS rows of it at once (independent
//   64-byte row loads) into shared memory below the highest climbing row,
//   and each lane takes its steps in the column from the slab: the climb,
//   then the step that leaves the column.  The next slab is loaded while
//   some lane still climbs.  A cell is a pure function of its position and
//   the plane is read-only, so a cell taken from the slab is the one the
//   plain walk fetches.
// * One cell a fetch off the column.  Loading several cells down a
//   diagonal at once cut the round trips but cost more time on the H100
//   than they saved (each extra cell is a sector of its own, in another
//   page, for each lane; PERF.md section 6).
// * Every output cell written by the kernel (the wrappers allocate with
//   torch.empty): each as the walk makes it (the stores are off the
//   chain), then qmap's columns the walk never left (column 0, and those
//   below a capped walk) and the string walk's columns past each row's
//   last emission, the latter a row at a time across the warp.
// * One warp a block spreads the reads' chains over every SM (19 968
//   lanes: 4.7 warps an SM; 512 lanes: 16 SMs); a warp's chains are its
//   lanes', so more warps an SM would add no chain.
//
// With ``counts`` non-null (measurement only; a build of each kernel
// without them is what the path launches) a launch adds its counters there
// (enum Count): fetching steps, the most dependent round trips of any lane
// (slab loads while it climbs, waits for a lower slab included, plus
// fetches), and fetching steps by kind.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WALK_THREADS = 32;  // one warp a block: chains spread over the SMs
constexpr int SLAB_ROWS = 32;  // rows of the fitting column a slab holds
constexpr unsigned FULL = 0xffffffffu;

// Counters a launch adds to (``counts``, int64 [N_COUNTS]): C_ROUNDS takes
// the maximum over lanes, the others the sum.
enum Count { C_FETCHES, C_ROUNDS, C_UP_LAST, C_UP_INNER, C_DIAG, C_LEFT, C_OTHER, N_COUNTS };

// Steps of the plain loop for a cap of ``cap``: whole blocks of 8 while the
// step count is below the cap.
__device__ __forceinline__ int capped_steps(int cap)
{
    return cap <= 0 ? 0 : ((cap + 7) / 8) * 8;
}

// A lane's counters (measurement only: compiled out when not ON).
template <bool ON>
struct Lane {
    unsigned k[N_COUNTS] = {};

    __device__ __forceinline__ void add(Count c, unsigned v = 1)
    {
        if (ON) k[c] += v;
    }

    __device__ __forceinline__ void add_to(unsigned long long* counts) const
    {
        if (!ON) return;
        atomicMax(counts + C_ROUNDS, (unsigned long long)k[C_ROUNDS]);
#pragma unroll
        for (int c = 0; c < N_COUNTS; ++c)
            if (c != C_ROUNDS && k[c]) atomicAdd(counts + c, (unsigned long long)k[c]);
    }
};

// The plain gather's cell at (col, row) of read n, its flat index clamped
// into [0, R * l1 - 1]: one load, one round trip.
template <class L>
__device__ __forceinline__ int fetch(const int16_t* __restrict__ dirs, int col, int row,
                                     int l1, long long cells, int n_pad, int n, L& cnt)
{
    long long idx = (long long)(col - 1) * l1 + row;
    idx = idx < 0 ? 0 : (idx > cells - 1 ? cells - 1 : idx);
    cnt.add(C_ROUNDS);
    return __ldg(dirs + idx * n_pad + n);
}

// fill_map (reference_align.cpp:280-305): is_match and dp_row [n_pad, R+1];
// up-runs write nothing.  A walk writes each column it leaves, from R down,
// so the columns it never left (column 0, and those below a capped walk's
// last column) are zeroed at its end.
template <bool COUNT>
__global__ void __launch_bounds__(WALK_THREADS) qmap_kernel(
    const int16_t* __restrict__ dirs, int R, int l1, int n_pad,
    const int32_t* __restrict__ lengths, int nlen,
    uint8_t* __restrict__ is_match, int32_t* __restrict__ dp_row,
    unsigned long long* __restrict__ counts)
{
    __shared__ int16_t slab[SLAB_ROWS][WALK_THREADS];
    const int lane = threadIdx.x;
    const int n0 = blockIdx.x * WALK_THREADS;
    const int n = n0 + lane;
    const bool live = n < n_pad;
    const long long cells = (long long)R * l1;
    const int steps = capped_steps(R + l1 + 4);
    uint8_t* const om = is_match + (size_t)n * (R + 1);
    int32_t* const orow = dp_row + (size_t)n * (R + 1);

    Lane<COUNT> cnt;
    int col = live ? R : 0;
    int row = live && n < nlen ? lengths[n] : 0;
    int rc = 0;  // left-run cells still to write
    int it = 0;

    // The walk's steps in column R, from slabs of plane column R - 1 (a row
    // past l1 - 1 clamps to its last cell): the climb, then the step that
    // leaves the column.  A row below 0 is the walk's to fetch.
    bool climbing = live && R > 0 && row > 0;
    const int16_t* column = dirs + (size_t)(R > 0 ? R - 1 : 0) * l1 * n_pad + n0 + lane;
    while (__any_sync(FULL, climbing)) {
        const int hi = __reduce_max_sync(FULL, climbing ? min(row, l1 - 1) : -1);
        const int lo = max(0, hi - SLAB_ROWS + 1);
        int16_t v[SLAB_ROWS];
#pragma unroll
        for (int k = 0; k < SLAB_ROWS; ++k)
            if (live && lo + k <= hi) v[k] = __ldg(column + (size_t)(lo + k) * n_pad);
#pragma unroll
        for (int k = 0; k < SLAB_ROWS; ++k)
            if (live && lo + k <= hi) slab[k][lane] = v[k];
        __syncwarp();
        if (climbing) cnt.add(C_ROUNDS);
        while (climbing && it < steps && row >= lo) {  // row >= 0 here
            const int d = slab[min(row, l1 - 1) - lo][lane];
            ++it;
            cnt.add(C_FETCHES);
            if (row > 0 && d < 0) {
                cnt.add(C_UP_LAST);
                row += d;
                climbing = row >= 0;
            } else if (d == 0) {
                cnt.add(C_DIAG);
                om[col] = true;
                orow[col] = row;
                --col;
                --row;
                climbing = false;
            } else if (d > 0) {
                cnt.add(C_LEFT);
                om[col] = false;
                orow[col] = row + 1;
                --col;
                rc = d - 1;
                climbing = false;
            } else {  // row 0, d < 0: nothing moves; the next step fetches it again
                cnt.add(C_OTHER);
            }
        }
        climbing = climbing && it < steps;
        __syncwarp();
    }

    while (it < steps && col > 0) {
        ++it;
        if (rc > 0) {  // a left run's later cell: no fetch
            om[col] = false;
            orow[col] = row + 1;
            --col;
            --rc;
            continue;
        }
        const int d = fetch(dirs, col, row, l1, cells, n_pad, n, cnt);
        cnt.add(C_FETCHES);
        if (row > 0 && d < 0) {
            if (col == R)
                cnt.add(C_UP_LAST);
            else
                cnt.add(C_UP_INNER);
            row += d;
        } else if (d == 0) {
            cnt.add(C_DIAG);
            om[col] = true;
            orow[col] = row;
            --col;
            --row;
        } else if (d > 0) {
            cnt.add(C_LEFT);
            om[col] = false;
            orow[col] = row + 1;
            --col;
            rc = d - 1;
        } else {  // row <= 0, d < 0: nothing moves; the next step fetches it again
            cnt.add(C_OTHER);
        }
    }

    for (int c = 0; live && c <= col; ++c) {
        om[c] = false;
        orow[c] = 0;
    }
    cnt.add_to(counts);
}

// reference_align.cpp:353-389: a_pos and b_pos [n_pad, T] (column t from
// the end: reference and query positions, 0 a gap), and ncols [n_pad]; one
// emission an active step, so a lane's step count is its column count.
// Each emission is stored as it is made (the stores are off the chain);
// the columns past a lane's last emission are zeroed at the end.
template <bool COUNT>
__global__ void __launch_bounds__(WALK_THREADS) string_kernel(
    const int16_t* __restrict__ dirs, int R, int l1, int n_pad,
    const int32_t* __restrict__ lengths, int nlen,
    int32_t* __restrict__ a_pos, int32_t* __restrict__ b_pos, int32_t* __restrict__ ncols,
    unsigned long long* __restrict__ counts)
{
    const int lane = threadIdx.x;
    const int n0 = blockIdx.x * WALK_THREADS;
    const int n = n0 + lane;
    const bool live = n < n_pad;
    const int rows = min(WALK_THREADS, n_pad - n0);
    const long long cells = (long long)R * l1;
    const int T = R + l1 + 1;
    const int steps = capped_steps(T + 8);
    int32_t* const oa = a_pos + (size_t)n * T;
    int32_t* const ob = b_pos + (size_t)n * T;

    Lane<COUNT> cnt;
    int col = live ? R : 0;
    int row = live && n < nlen ? lengths[n] : 0;
    int rc = 0, uc = 0;  // left and up cells still to emit
    int t = 0;  // steps taken = columns emitted
    while (t < steps && (col > 0 || row > 0)) {
        const bool fresh = rc == 0 && uc == 0;
        const bool tailq = fresh && col == 0;  // reference exhausted: the query's first rows
        bool see_up = false, diag = false, newl = false;
        if (fresh && !tailq) {
            const int d = fetch(dirs, col, row, l1, cells, n_pad, n, cnt);
            cnt.add(C_FETCHES);
            see_up = row > 0 && d < 0;
            diag = !see_up && d == 0;
            newl = !see_up && d > 0;
            if (see_up) {
                if (col == R)
                    cnt.add(C_UP_LAST);
                else
                    cnt.add(C_UP_INNER);
                uc = -d;
            } else if (newl) {
                cnt.add(C_LEFT);
                rc = d;
            } else if (diag) {
                cnt.add(C_DIAG);
            } else {  // row <= 0, d < 0: emits (0, 0); the next step fetches it again
                cnt.add(C_OTHER);
            }
        }
        const bool emit_up = uc > 0 && !diag && !newl && !tailq;
        const bool emit_left = rc > 0 && !emit_up && !diag && !tailq;
        const bool step_q = emit_up || tailq || diag;
        const bool step_r = emit_left || diag;
        if (t < T) {
            oa[t] = step_r ? col : 0;
            ob[t] = step_q ? row : 0;
        }
        row -= step_q;
        col -= step_r;
        uc -= emit_up;
        rc -= emit_left;
        ++t;
    }
    // The columns past each row's last emission, a row at a time across
    // the warp: 128-byte stores.
    for (int i = 0; i < rows; ++i) {
        const int f = __shfl_sync(FULL, t, i);
        int32_t* const ra = a_pos + (size_t)(n0 + i) * T;
        int32_t* const rb = b_pos + (size_t)(n0 + i) * T;
        for (int k = f + lane; k < T; k += WALK_THREADS) {
            ra[k] = 0;
            rb[k] = 0;
        }
    }
    if (live) ncols[n] = t;
    cnt.add_to(counts);
}

template <typename K>
int attrs(K kernel, int* out)
{
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, WALK_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = (int)a.localSizeBytes;
    out[3] = blocks;
    out[4] = WALK_THREADS;
    return 0;
}

}  // namespace

// dirs int16 [R, l1, n_pad]; lengths int32 [nlen], nlen <= n_pad; is_match
// uint8 (bool) and dp_row int32 [n_pad, R + 1], every cell written here;
// counts NULL, or int64 [N_COUNTS] that gains the launch's counters.
extern "C" int sarlacc_qmap_kernel(
    const int16_t* dirs, int R, int l1, int n_pad, const int32_t* lengths, int nlen,
    uint8_t* is_match, int32_t* dp_row, unsigned long long* counts, void* stream)
{
    if (R < 0 || l1 < 1 || n_pad < 0 || nlen < 0 || nlen > n_pad) return (int)cudaErrorInvalidValue;
    if (n_pad == 0) return 0;
    const int blocks = (n_pad + WALK_THREADS - 1) / WALK_THREADS;
    if (counts)
        qmap_kernel<true><<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
            dirs, R, l1, n_pad, lengths, nlen, is_match, dp_row, counts);
    else
        qmap_kernel<false><<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
            dirs, R, l1, n_pad, lengths, nlen, is_match, dp_row, counts);
    return (int)cudaGetLastError();
}

// dirs int16 [R, l1, n_pad]; lengths int32 [nlen]; a_pos, b_pos
// int32 [n_pad, R + l1 + 1] and ncols int32 [n_pad], every cell written
// here; counts as sarlacc_qmap_kernel's.
extern "C" int sarlacc_string_kernel(
    const int16_t* dirs, int R, int l1, int n_pad, const int32_t* lengths, int nlen,
    int32_t* a_pos, int32_t* b_pos, int32_t* ncols, unsigned long long* counts, void* stream)
{
    if (R < 0 || l1 < 1 || n_pad < 0 || nlen < 0 || nlen > n_pad) return (int)cudaErrorInvalidValue;
    if (n_pad == 0) return 0;
    const int blocks = (n_pad + WALK_THREADS - 1) / WALK_THREADS;
    if (counts)
        string_kernel<true><<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
            dirs, R, l1, n_pad, lengths, nlen, a_pos, b_pos, ncols, counts);
    else
        string_kernel<false><<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
            dirs, R, l1, n_pad, lengths, nlen, a_pos, b_pos, ncols, counts);
    return (int)cudaGetLastError();
}

// Resources of walk ``which`` (0 qmap, 1 string) as the path launches it
// (no counters): out[0..4] = registers a thread, static shared bytes a
// block, local (spill) bytes a thread, resident blocks an SM, threads a
// block.
extern "C" int sarlacc_backtrack_attrs(int which, int* out)
{
    return which == 0 ? attrs(qmap_kernel<false>, out) : attrs(string_kernel<false>, out);
}
