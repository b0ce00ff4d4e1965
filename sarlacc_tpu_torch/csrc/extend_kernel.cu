// Kernel H: the device library's consistency extension, every output pair
// of a library build composed through its middle sequences' position maps.
//
// Replaces sarlacc_tpu/ops/msa.py::_extend_chunk_kernel (:1320), a jitted
// program of row gathers, a lane-wise sort along the slots, SL unrolled
// masked adds and a per-pair packing sort, fed by host-built [CP, SL] slot
// tables.  Plain PyTorch version: sarlacc_tpu_torch/ops/msa.py::
// _extend_library_plain (the slot tables by torch ops, then
// ::_extend_chunk_plain); the entries and the counts are bit-identical.
//
// Inputs, uploaded once a library build: the int16 arena [rows, STR] of
// position maps (row 2 + 2 j the forward map of job j, row 3 + 2 j its
// reverse, row 1 the identity); per job j (an output pair x < y of one
// group) jobs[j] = (group, x, y, g), g the group's size; per group its
// first job id; the float32 pair identities fracs[j]; order, the job ids in
// chunk order.  A chunk is a range of order plus its slot class SL and its
// A-positions strc.
//
// Each lane derives its slot on chip, as the host's triple loop did: slot
// 0 is the job's own forward map through the identity row, weight
// ident(x, y) * 100; slot s >= 1 is middle sequence z = s - 1 stepped past
// x and then past y (z ascending, x and y skipped: the slot order the
// weights are summed in), maps x -> z then z -> y, weight min(ident(x, z),
// ident(z, y)) * 100; slots s >= g - 1 are dead.  The arena row of u -> v
// is 2 + 2 jobid(u, v) for u < v and 3 + 2 jobid(v, u) otherwise, jobid(u,
// v) = first + u g - u (u + 1) / 2 + v - u - 1 (np.triu_indices' order).
// A weight is rounded as numpy rounds it on the host: the float32
// identities widened to float64, Python's min (the second only if it is
// smaller), one float64 multiply by 100.0, then one rounding to float32.
//
// One block a pair, one warp an A-position a, one lane a slot: lane s
// gathers k = arena[xz, a] and b = arena[zy, k] (0 where k <= 0); its key
// is b, or DEAD for b <= 0 and for dead lanes.  Lanes of equal key find
// each other by __match_any_sync; the lowest slot of a run is its first
// (the stable sort's order), and it is kept when its key is live and a >
// 0.  Every lane sums the weights of its run in slot order, one add at a
// time from 0.0f, which is what the plain version's masked adds compute (a
// tree sum or atomics would change last bits, and a last-bit weight change
// flips a merge tie), then round(wsum * scale), half to even.  A kept
// entry's rank within its A-position is the number of kept keys below its
// own, so the entries come out by a, then b.
//
// Passes, all queued back to back with no host wait between them: pass 0
// (one launch a chunk) counts each (p, a)'s kept entries into one byte of
// cnt and each pair's total into pair_tot; pass 2 (one launch a build) is
// a block-wide exclusive scan of every pair's total into int64 offsets,
// the total last, which the host reads back once, with the per-pair counts
// it needs; pass 1 (one launch a chunk) recomputes each (p, a), scans its
// pair's byte counts in 256-item tiles and writes the rows (a, b, weight)
// straight into the one preallocated table at the pair's offset.
//
// What bounds it: bytes.  Lane s's gather of its first-hop row at column a
// hits the same 32-byte sector for 16 consecutive A-positions, which a warp
// walks in turn, so the arena's gathered entries, the per-job tables and
// identities and the 12 bytes a kept entry are the compulsory traffic;
// each of the two passes reads the gathers once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int EXT_THREADS = 256;        // eight warps a pair
constexpr int EXT_WARPS = EXT_THREADS / 32;
constexpr int DEAD = 1 << 20;           // a dead slot's key: past every position
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;           // consecutive pair totals a thread
constexpr int IDENT_ROW = 1;

struct Slot {
    const int16_t* xz;  // the two hops' arena rows
    const int16_t* zy;
    float w;
    bool live;
};

// Arena row of the position map u -> v within a group of g reads whose
// first job is ``first``.
__device__ __forceinline__ long long map_row(long long first, int g, int u, int v)
{
    const int lo = u < v ? u : v, hi = u < v ? v : u;
    const long long jid = first + (long long)lo * g - (long long)lo * (lo + 1) / 2 + (hi - lo - 1);
    return 2 + 2 * jid + (u > v);
}

// float32(float64 weight * 100.0), as numpy computes the host's slot weight.
__device__ __forceinline__ float weight(double ident)
{
    return __double2float_rn(__dmul_rn(ident, 100.0));
}

// Lane ``lane``'s slot of the job ``job``: its rows and weight, derived
// from the job's (group, x, y, g), the group's first job and the identities.
__device__ __forceinline__ Slot load_slot(const int16_t* __restrict__ arena, long long STR,
                                          const int32_t* __restrict__ jobs,
                                          const int32_t* __restrict__ first_job,
                                          const float* __restrict__ fracs, int job, int lane)
{
    const int4 jb = reinterpret_cast<const int4*>(jobs)[job];  // (group, x, y, g)
    const int x = jb.y, y = jb.z, g = jb.w;
    Slot s{arena, arena, 0.0f, lane < g - 1};
    if (!s.live) return s;
    if (lane == 0) {
        s.xz = arena + (2 + 2 * (long long)job) * STR;
        s.zy = arena + IDENT_ROW * STR;
        s.w = weight((double)fracs[job]);
        return s;
    }
    const long long first = first_job[jb.x];
    int z = lane - 1;
    z += z >= x;
    z += z >= y;
    const long long rxz = map_row(first, g, x, z), rzy = map_row(first, g, z, y);
    s.xz = arena + rxz * STR;
    s.zy = arena + rzy * STR;
    // The jobid of (u, v) is (row - 2) / 2 for either direction.
    const double ixz = (double)fracs[(rxz - 2) >> 1];
    const double izy = (double)fracs[(rzy - 2) >> 1];
    s.w = weight(izy < ixz ? izy : ixz);  // Python's min(ixz, izy)
    return s;
}

struct Entry {
    int key;      // b, or DEAD
    unsigned run; // lanes holding the same key
    bool kept;
};

// The lane's candidate at A-position ``a``, its run and whether it is kept.
__device__ __forceinline__ Entry compose(const Slot& s, int a, int lane)
{
    int b = 0;
    if (s.live) {
        const int k = s.xz[a];
        if (k > 0) b = s.zy[k];
    }
    Entry e;
    e.key = b > 0 ? b : DEAD;
    e.run = __match_any_sync(FULL, e.key);
    const bool first = (e.run & ((1u << lane) - 1u)) == 0;
    e.kept = e.key < DEAD && first && a > 0;
    return e;
}

// Pass 0 on one chunk: kept counts per (p, a) into cnt[p * strc + a] (at
// most 32: one byte) and per pair into pair_tot[p].
__global__ void __launch_bounds__(EXT_THREADS) extend_count(
    const int16_t* __restrict__ arena, long long STR, const int32_t* __restrict__ jobs,
    const int32_t* __restrict__ first_job, const float* __restrict__ fracs,
    const int32_t* __restrict__ order, int strc, uint8_t* __restrict__ cnt,
    int32_t* __restrict__ pair_tot)
{
    __shared__ int warp_tot[EXT_WARPS];
    const int p = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Slot s = load_slot(arena, STR, jobs, first_job, fracs, order[p], lane);
    int total = 0;
    for (int chunk = 0; chunk < strc; chunk += EXT_THREADS) {
        const int a0 = chunk + warp * 32;
        int mine = 0;  // lane k keeps item a0 + k's count
        for (int k = 0; k < 32 && a0 + k < strc; ++k) {
            const Entry e = compose(s, a0 + k, lane);
            const int c = __popc(__ballot_sync(FULL, e.kept));
            if (lane == k) mine = c;
            total += c;
        }
        if (a0 + lane < strc) cnt[(size_t)p * strc + a0 + lane] = (uint8_t)mine;
    }
    if (lane == 0) warp_tot[warp] = total;
    __syncthreads();
    if (threadIdx.x == 0) {
        int t = 0;
        for (int i = 0; i < EXT_WARPS; ++i) t += warp_tot[i];
        pair_tot[p] = t;
    }
}

// Exclusive block-wide scan of one value a thread (SCAN_THREADS threads):
// returns the sum of the values of the threads below, and the block's total.
template <typename T>
__device__ __forceinline__ T block_exclusive(T v, T* warp_part, T& total)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    T inc = v;
    for (int d = 1; d < 32; d <<= 1) {
        const T u = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc += u;
    }
    if (lane == 31) warp_part[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        T w = lane < warps ? warp_part[lane] : (T)0;
        for (int d = 1; d < 32; d <<= 1) {
            const T u = __shfl_up_sync(FULL, w, d);
            if (lane >= d) w += u;
        }
        if (lane < warps) warp_part[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const T below = (warp ? warp_part[warp - 1] : (T)0) + inc - v;
    total = warp_part[warps - 1];
    __syncthreads();  // warp_part is rewritten by the next call
    return below;
}

// Pass 2: off[0 .. n] = exclusive prefix sums of pair_tot[0 .. n - 1], the
// total last; tiles of SCAN_THREADS x SCAN_ITEMS totals, carried in order.
__global__ void __launch_bounds__(SCAN_THREADS) extend_scan(
    const int32_t* __restrict__ pair_tot, int n, long long* __restrict__ off)
{
    __shared__ long long warp_part[SCAN_THREADS / 32];
    long long carry = 0;
    for (int t0 = 0; t0 < n; t0 += SCAN_THREADS * SCAN_ITEMS) {
        const int i0 = t0 + threadIdx.x * SCAN_ITEMS;
        long long v[SCAN_ITEMS], mine = 0;
#pragma unroll
        for (int k = 0; k < SCAN_ITEMS; ++k) {
            v[k] = i0 + k < n ? pair_tot[i0 + k] : 0;
            mine += v[k];
        }
        long long total;
        long long run = carry + block_exclusive(mine, warp_part, total);
#pragma unroll
        for (int k = 0; k < SCAN_ITEMS; ++k) {
            if (i0 + k < n) off[i0 + k] = run;
            run += v[k];
        }
        carry += total;
    }
    if (threadIdx.x == 0) off[n] = carry;
}

// Pass 1 on one chunk: the rows (a, b, round(wsum * scale)) of pair p at
// out[off[p] ..], by a, then b.
__global__ void __launch_bounds__(EXT_THREADS) extend_write(
    const int16_t* __restrict__ arena, long long STR, const int32_t* __restrict__ jobs,
    const int32_t* __restrict__ first_job, const float* __restrict__ fracs,
    const int32_t* __restrict__ order, int SL, int strc, const float* __restrict__ scale,
    const uint8_t* __restrict__ cnt, const long long* __restrict__ off,
    int32_t* __restrict__ out)
{
    __shared__ int excl[EXT_THREADS];
    __shared__ int warp_sum[EXT_WARPS];
    const int p = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Slot s = load_slot(arena, STR, jobs, first_job, fracs, order[p], lane);
    const float ws = *scale;
    const long long pair_base = off[p];
    int base = 0;  // entries of this pair before the tile
    for (int chunk = 0; chunk < strc; chunk += EXT_THREADS) {
        // Exclusive scan of the tile's 256 item counts.
        const int item = chunk + threadIdx.x;
        const int c = item < strc ? cnt[(size_t)p * strc + item] : 0;
        int inc = c;
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += v;
        }
        if (lane == 31) warp_sum[warp] = inc;
        __syncthreads();
        int before = 0, chunk_tot = 0;
        for (int i = 0; i < EXT_WARPS; ++i) {
            before += i < warp ? warp_sum[i] : 0;
            chunk_tot += warp_sum[i];
        }
        excl[threadIdx.x] = base + before + inc - c;
        __syncthreads();

        const int a0 = chunk + warp * 32;
        for (int k = 0; k < 32 && a0 + k < strc; ++k) {
            if (!__shfl_sync(FULL, c, k)) continue;  // item a0 + k keeps nothing
            const Entry e = compose(s, a0 + k, lane);
            const unsigned kmask = __ballot_sync(FULL, e.kept);
            float wsum = 0.0f;
            int below = 0;
            for (int t = 0; t < SL; ++t) {
                const float wt = __shfl_sync(FULL, s.w, t);
                const int kt = __shfl_sync(FULL, e.key, t);
                if ((e.run >> t) & 1u) wsum = __fadd_rn(wsum, wt);
                below += ((kmask >> t) & 1u) && kt < e.key;
            }
            if (e.kept) {
                const size_t row = (size_t)(pair_base + excl[warp * 32 + k] + below) * 3;
                out[row] = a0 + k;
                out[row + 1] = e.key;
                out[row + 2] = __float2int_rn(__fmul_rn(wsum, ws));
            }
        }
        base += chunk_tot;
        __syncthreads();  // excl and warp_sum are rewritten by the next tile
    }
}

template <typename K>
int attrs(K kernel, int threads, int* out)
{
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = (int)a.localSizeBytes;
    out[3] = blocks;
    out[4] = threads;
    return 0;
}

}  // namespace

// Every pass takes arena int16 [*, STR]; jobs int32 [J, 4] (group, x, y,
// g); first_job int32 [groups]; fracs float32 [J]; and, for one chunk of CP
// pairs, order int32 [CP] (job ids), SL (1 <= g - 1 <= SL <= 32 for every
// job of the chunk, checked by the wrapper) and strc.  pass 0: cnt uint8
// [CP * strc] and pair_tot int32 [CP] of the chunk.  pass 2: pair_tot int32
// [CP] of the whole build (CP = J) and off int64 [CP + 1].  pass 1: scale
// float32 [1], cnt as pass 0 left it, off int64 [CP] (the chunk's pairs'
// offsets) and out int32 [*, 3], the whole table.
extern "C" int sarlacc_extend_kernel(
    int pass, const int16_t* arena, long long STR, const int32_t* jobs, const int32_t* first_job,
    const float* fracs, const int32_t* order, int CP, int SL, int strc, const float* scale,
    uint8_t* cnt, int32_t* pair_tot, long long* off, int32_t* out, void* stream)
{
    if (CP < 0 || SL < 1 || SL > 32 || strc < 0 || STR < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (pass == 0) {
        if (CP > 0)
            extend_count<<<CP, EXT_THREADS, 0, st>>>(
                arena, STR, jobs, first_job, fracs, order, strc, cnt, pair_tot);
    } else if (pass == 1) {
        if (CP > 0)
            extend_write<<<CP, EXT_THREADS, 0, st>>>(
                arena, STR, jobs, first_job, fracs, order, SL, strc, scale, cnt, off, out);
    } else if (pass == 2) {
        extend_scan<<<1, SCAN_THREADS, 0, st>>>(pair_tot, CP, off);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Resources of pass ``which`` (0 count, 1 write, 2 scan): out[0..4] as
// csrc/walk_kernel.cu's sarlacc_walk_attrs.
extern "C" int sarlacc_extend_attrs(int which, int* out)
{
    if (which == 0) return attrs(extend_count, EXT_THREADS, out);
    if (which == 1) return attrs(extend_write, EXT_THREADS, out);
    return attrs(extend_scan, SCAN_THREADS, out);
}
