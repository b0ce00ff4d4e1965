// Kernel H: the device library's consistency extension, one chunk of
// output pairs composed through their middle sequences' position maps.
//
// Replaces sarlacc_tpu/ops/msa.py::_extend_chunk_kernel (:1320), a jitted
// program of row gathers, a lane-wise sort along the slots, SL unrolled
// masked adds and a per-pair packing sort.  Plain PyTorch version:
// sarlacc_tpu_torch/ops/msa.py::_extend_chunk_plain; the entries and the
// counts are bit-identical.
//
// Inputs: the int16 arena [rows, STR] of position maps; per output pair p
// of the chunk and slot s < SL (SL <= 32) the arena rows xz[p, s] and
// zy[p, s] (int64) and the weight w[p, s] (float32); pair_ids (int64) into
// the int64 counts; the float32 quantization scale on the device; strc,
// the A-positions the chunk composes.
//
// One block a pair, one warp an A-position a, one lane a slot: lane s
// gathers k = arena[xz[p, s], a] and b = arena[zy[p, s], k] (0 where k <=
// 0); its key is b, or DEAD for b <= 0 and for lanes past SL.  Lanes of
// equal key find each other by __match_any_sync; the lowest slot of a run
// is its first (the stable sort's order), and it is kept when its key is
// live and a > 0.  Every lane sums the weights of its run in slot order,
// one add at a time from 0.0f, which is what the plain version's masked
// adds compute (a tree sum or atomics would change last bits, and a
// last-bit weight change flips a merge tie), then round(wsum * scale),
// half to even.  A kept entry's rank within its A-position is the number
// of kept keys below its own, so the entries come out by a, then b.
//
// Two passes and a scan, so no thread waits on another's output size:
// pass 0 counts each (p, a)'s kept entries into cnt[p * strc + a], each
// pair's total into pair_tot and adds it to counts[pair_ids[p]] (integer
// atomics, exact in any order); the scan turns pair_tot into exclusive
// offsets, the total last, which the host reads once to size the output;
// pass 1 recomputes each (p, a), scans its block's counts in 256-item
// chunks in shared memory and writes the rows (a, b, weight).
//
// What bounds it: bytes.  Lane s's gather of row xz[p, s] at column a hits
// the same 32-byte sector for 16 consecutive A-positions, which a warp
// walks in turn, so the arena's gathered entries, the slot tables and the
// 12 bytes a kept entry are the compulsory traffic; each pass reads the
// gathers once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int EXT_THREADS = 256;        // eight warps a pair
constexpr int EXT_WARPS = EXT_THREADS / 32;
constexpr int DEAD = 1 << 20;           // a dead slot's key: past every position
constexpr int SCAN_THREADS = 1024;

struct Slot {
    const int16_t* xz;  // the two hops' arena rows
    const int16_t* zy;
    float w;
    bool live;          // s < SL
};

__device__ __forceinline__ Slot load_slot(const int16_t* __restrict__ arena, long long STR,
                                          const int64_t* __restrict__ xz,
                                          const int64_t* __restrict__ zy,
                                          const float* __restrict__ w, int p, int SL, int lane)
{
    Slot s{arena, arena, 0.0f, lane < SL};
    if (s.live) {
        const size_t at = (size_t)p * SL + lane;
        s.xz = arena + xz[at] * STR;
        s.zy = arena + zy[at] * STR;
        s.w = w[at];
    }
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

// Pass 0: kept counts per (p, a), per pair, and into counts[pair_ids[p]].
__global__ void __launch_bounds__(EXT_THREADS) extend_count(
    const int16_t* __restrict__ arena, long long STR,
    const int64_t* __restrict__ xz, const int64_t* __restrict__ zy,
    const float* __restrict__ w, int SL, int strc,
    const int64_t* __restrict__ pair_ids, unsigned long long* __restrict__ counts,
    int32_t* __restrict__ cnt, int32_t* __restrict__ pair_tot)
{
    __shared__ int warp_tot[EXT_WARPS];
    const int p = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Slot s = load_slot(arena, STR, xz, zy, w, p, SL, lane);
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
        if (a0 + lane < strc) cnt[(size_t)p * strc + a0 + lane] = mine;
    }
    if (lane == 0) warp_tot[warp] = total;
    __syncthreads();
    if (threadIdx.x == 0) {
        int t = 0;
        for (int i = 0; i < EXT_WARPS; ++i) t += warp_tot[i];
        pair_tot[p] = t;
        if (t) atomicAdd(counts + pair_ids[p], (unsigned long long)t);
    }
}

// Exclusive offsets of the CP pair totals into off[0 .. CP], the total last.
__global__ void __launch_bounds__(SCAN_THREADS) extend_scan(
    const int32_t* __restrict__ pair_tot, int CP, int32_t* __restrict__ off)
{
    __shared__ int part[SCAN_THREADS];
    const int per = (CP + SCAN_THREADS - 1) / SCAN_THREADS;
    const int lo = threadIdx.x * per;
    const int hi = lo + per < CP ? lo + per : CP;
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += pair_tot[i];
    part[threadIdx.x] = sum;
    __syncthreads();
    for (int d = 1; d < SCAN_THREADS; d <<= 1) {  // inclusive Hillis-Steele
        const int v = threadIdx.x >= d ? part[threadIdx.x - d] : 0;
        __syncthreads();
        part[threadIdx.x] += v;
        __syncthreads();
    }
    int run = part[threadIdx.x] - sum;
    for (int i = lo; i < hi; ++i) {
        off[i] = run;
        run += pair_tot[i];
    }
    if (threadIdx.x == SCAN_THREADS - 1) off[CP] = part[SCAN_THREADS - 1];
}

// Pass 1: the rows (a, b, round(wsum * scale)) at each pair's offset.
__global__ void __launch_bounds__(EXT_THREADS) extend_write(
    const int16_t* __restrict__ arena, long long STR,
    const int64_t* __restrict__ xz, const int64_t* __restrict__ zy,
    const float* __restrict__ w, int SL, int strc, const float* __restrict__ scale,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ off,
    int32_t* __restrict__ out)
{
    __shared__ int excl[EXT_THREADS];
    __shared__ int warp_sum[EXT_WARPS];
    const int p = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Slot s = load_slot(arena, STR, xz, zy, w, p, SL, lane);
    const float ws = *scale;
    int base = off[p];
    for (int chunk = 0; chunk < strc; chunk += EXT_THREADS) {
        // Exclusive scan of the chunk's 256 item counts.
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
            const Entry e = compose(s, a0 + k, lane);
            const unsigned kmask = __ballot_sync(FULL, e.kept);
            if (!kmask) continue;
            float wsum = 0.0f;
            int below = 0;
            for (int t = 0; t < SL; ++t) {
                const float wt = __shfl_sync(FULL, s.w, t);
                const int kt = __shfl_sync(FULL, e.key, t);
                if ((e.run >> t) & 1u) wsum = __fadd_rn(wsum, wt);
                below += ((kmask >> t) & 1u) && kt < e.key;
            }
            if (e.kept) {
                const size_t row = (size_t)(excl[warp * 32 + k] + below) * 3;
                out[row] = a0 + k;
                out[row + 1] = e.key;
                out[row + 2] = __float2int_rn(__fmul_rn(wsum, ws));
            }
        }
        base += chunk_tot;
        __syncthreads();  // excl and warp_sum are rewritten by the next chunk
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

// pass 0: arena int16 [*, STR]; xz, zy int64 and w float32 [CP, SL] (1 <=
// SL <= 32); pair_ids int64 [CP] into counts int64; cnt int32 [CP * strc];
// pair_tot int32 [CP]; off int32 [CP + 1] gets the exclusive offsets, the
// total last.  pass 1: the same tables, scale float32 [1], cnt and off as
// pass 0 left them, and out int32 [off[CP], 3].
extern "C" int sarlacc_extend_kernel(
    int pass, const int16_t* arena, long long STR, const int64_t* xz, const int64_t* zy,
    const float* w, int CP, int SL, int strc, const int64_t* pair_ids, int64_t* counts,
    const float* scale, int32_t* cnt, int32_t* pair_tot, int32_t* off, int32_t* out,
    void* stream)
{
    if (CP < 0 || SL < 1 || SL > 32 || strc < 0 || STR < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (pass == 0) {
        if (CP > 0)
            extend_count<<<CP, EXT_THREADS, 0, st>>>(
                arena, STR, xz, zy, w, SL, strc, pair_ids, (unsigned long long*)counts, cnt,
                pair_tot);
        extend_scan<<<1, SCAN_THREADS, 0, st>>>(pair_tot, CP, off);
    } else if (pass == 1) {
        if (CP > 0)
            extend_write<<<CP, EXT_THREADS, 0, st>>>(
                arena, STR, xz, zy, w, SL, strc, scale, cnt, off, out);
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
