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
// column the step before resolved, so a read is a chain of up to R + l1
// dependent loads from device memory; the walk of the widest read takes
// about that many load latencies, whatever the card's bandwidth.  One warp
// a block spreads the reads' chains over every SM.  Only a step that
// reads a direction fetches (a run's later cells need none).  Its
// compulsory traffic is the 2-byte cell of each fetching step (a walk
// never fetches a cell twice, and reads walk apart) plus the lengths and
// outputs; with ``fetches`` non-null (measurement only) each thread adds
// its fetching steps there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WALK_THREADS = 32;  // one warp a block: chains spread over the SMs

// Steps of the plain loop for a cap of ``cap``: whole blocks of 8 while the
// step count is below the cap.
__device__ __forceinline__ int capped_steps(int cap)
{
    return cap <= 0 ? 0 : ((cap + 7) / 8) * 8;
}

__device__ __forceinline__ int fetch(const int16_t* __restrict__ dirs, int col, int row,
                                     int l1, long long cells, int n_pad, int n)
{
    long long idx = (long long)(col - 1) * l1 + row;
    idx = idx < 0 ? 0 : (idx > cells - 1 ? cells - 1 : idx);
    return (int)dirs[idx * n_pad + n];
}

// fill_map (reference_align.cpp:280-305): is_match and dp_row [n_pad, R+1],
// zeroed by the caller; up-runs write nothing, column 0 stays (false, 0).
__global__ void __launch_bounds__(WALK_THREADS) qmap_kernel(
    const int16_t* __restrict__ dirs, int R, int l1, int n_pad,
    const int32_t* __restrict__ lengths, int nlen,
    uint8_t* __restrict__ is_match, int32_t* __restrict__ dp_row,
    unsigned long long* __restrict__ fetches)
{
    const int n = blockIdx.x * WALK_THREADS + threadIdx.x;
    if (n >= n_pad) return;
    const long long cells = (long long)R * l1;
    const int steps = capped_steps(R + l1 + 4);
    const size_t out = (size_t)n * (R + 1);
    int col = R;
    int row = n < nlen ? lengths[n] : 0;
    int rc = 0;  // left-run cells still to write
    unsigned long long fetched = 0;
    for (int it = 0; it < steps && col > 0; ++it) {
        if (rc > 0) {  // a left run's later cell: no fetch
            is_match[out + col] = false;
            dp_row[out + col] = row + 1;
            --col;
            --rc;
            continue;
        }
        const int d = fetch(dirs, col, row, l1, cells, n_pad, n);
        ++fetched;
        const bool up = row > 0 && d < 0;
        const bool diag = !up && d == 0;
        const bool left_new = !up && d > 0;
        if (diag || left_new) {
            is_match[out + col] = diag;
            dp_row[out + col] = diag ? row : row + 1;
            --col;
        }
        row = up ? row + d : (diag ? row - 1 : row);
        rc = left_new ? d - 1 : 0;
    }
    if (fetches) atomicAdd(fetches, fetched);
}

// reference_align.cpp:353-389: a_pos and b_pos [n_pad, T] (column t from
// the end: reference and query positions, 0 a gap), zeroed by the caller,
// and ncols [n_pad]; one emission an active step.
__global__ void __launch_bounds__(WALK_THREADS) string_kernel(
    const int16_t* __restrict__ dirs, int R, int l1, int n_pad,
    const int32_t* __restrict__ lengths, int nlen,
    int32_t* __restrict__ a_pos, int32_t* __restrict__ b_pos, int32_t* __restrict__ ncols,
    unsigned long long* __restrict__ fetches)
{
    const int n = blockIdx.x * WALK_THREADS + threadIdx.x;
    if (n >= n_pad) return;
    const long long cells = (long long)R * l1;
    const int T = R + l1 + 1;
    const int steps = capped_steps(T + 8);
    const size_t out = (size_t)n * T;
    int col = R;
    int row = n < nlen ? lengths[n] : 0;
    int rc = 0, uc = 0;  // left and up cells still to emit
    int t = 0;
    unsigned long long fetched = 0;
    for (int it = 0; it < steps && (col > 0 || row > 0); ++it) {
        const bool fresh = rc == 0 && uc == 0;
        const bool tailq = fresh && col == 0;  // reference exhausted: the query's first rows
        bool see_up = false, diag = false, newl = false;
        if (fresh && !tailq) {
            const int d = fetch(dirs, col, row, l1, cells, n_pad, n);
            ++fetched;
            see_up = row > 0 && d < 0;
            diag = !see_up && d == 0;
            newl = !see_up && d > 0;
            if (see_up) uc = -d;
            if (newl) rc = d;
        }
        const bool emit_up = uc > 0 && !diag && !newl && !tailq;
        const bool emit_left = rc > 0 && !emit_up && !diag && !tailq;
        const bool step_q = emit_up || tailq || diag;
        const bool step_r = emit_left || diag;
        if (t < T) {
            a_pos[out + t] = step_r ? col : 0;
            b_pos[out + t] = step_q ? row : 0;
        }
        row -= step_q;
        col -= step_r;
        uc -= emit_up;
        rc -= emit_left;
        ++t;
    }
    ncols[n] = t;
    if (fetches) atomicAdd(fetches, fetched);
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
// uint8 (bool) and dp_row int32 [n_pad, R + 1], zeroed by the caller;
// fetches NULL, or a uint64 that gains the launch's fetching steps.
extern "C" int sarlacc_qmap_kernel(
    const int16_t* dirs, int R, int l1, int n_pad, const int32_t* lengths, int nlen,
    uint8_t* is_match, int32_t* dp_row, unsigned long long* fetches, void* stream)
{
    if (R < 0 || l1 < 1 || n_pad < 0 || nlen < 0 || nlen > n_pad) return (int)cudaErrorInvalidValue;
    if (n_pad == 0 || R == 0) return 0;
    const int blocks = (n_pad + WALK_THREADS - 1) / WALK_THREADS;
    qmap_kernel<<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
        dirs, R, l1, n_pad, lengths, nlen, is_match, dp_row, fetches);
    return (int)cudaGetLastError();
}

// dirs int16 [R, l1, n_pad]; lengths int32 [nlen]; a_pos, b_pos
// int32 [n_pad, R + l1 + 1], zeroed by the caller; ncols int32 [n_pad];
// fetches as sarlacc_qmap_kernel's.
extern "C" int sarlacc_string_kernel(
    const int16_t* dirs, int R, int l1, int n_pad, const int32_t* lengths, int nlen,
    int32_t* a_pos, int32_t* b_pos, int32_t* ncols, unsigned long long* fetches, void* stream)
{
    if (R < 0 || l1 < 1 || n_pad < 0 || nlen < 0 || nlen > n_pad) return (int)cudaErrorInvalidValue;
    if (n_pad == 0) return 0;
    const int blocks = (n_pad + WALK_THREADS - 1) / WALK_THREADS;
    string_kernel<<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
        dirs, R, l1, n_pad, lengths, nlen, a_pos, b_pos, ncols, fetches);
    return (int)cudaGetLastError();
}

// Resources of walk ``which`` (0 qmap, 1 string): out[0..4] = registers a
// thread, static shared bytes a block, local (spill) bytes a thread,
// resident blocks an SM, threads a block.
extern "C" int sarlacc_backtrack_attrs(int which, int* out)
{
    return which == 0 ? attrs(qmap_kernel, out) : attrs(string_kernel, out);
}
