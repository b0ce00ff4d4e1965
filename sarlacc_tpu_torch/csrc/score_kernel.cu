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
// Layout and design follow kernel A (dir_kernel.cu) without the direction
// bookkeeping: every plane is [l1, n_pad] with reads on the fast axis, so a
// warp reads and writes 32 consecutive reads of one DP row (coalesced).
// One thread owns one read and walks the reference columns in order, and
// within a column the rows in order, so the vertical-gap prefix max that
// the TPU kernel builds with log-shift scans is a running scalar.  Max is
// exact, so the serial running max gives the same bits.  Only rows 0..len
// of a read are computed: a cell depends on rows at or above it, never
// below, so the rows past the read's end cannot change its score.  Each
// thread keeps the score of row len as it goes; only the gathered score
// leaves the kernel ([N] for C, [nseg, n_pad] for D).
//
// What bounds it: memory traffic.  Per cell the thread reads S, H, the code
// and one cost plane and writes S and H: about 24 bytes per cell against a
// dozen flops.  The per-row state lives in device memory (the scratch
// planes S and H); a later design keeps a block of columns in registers
// per row sweep, or the whole per-column state in shared memory.
//
// Exactness: compile with --fmad=false.  The association
// (mv - go) + i*ge and cum - (i-1)*ge must not contract into FMAs, or the
// last bit moves and the barcode argmax can flip on a tie.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -3.0e38f;

// One read's DP against columns modes/mask[0, rlen); returns S at row len
// after the last column (column 0's value when rlen == 0).
__device__ float score_one(
    int n, const int32_t* __restrict__ modes, const int32_t* __restrict__ mask,
    int rlen, float go, float ge, bool local,
    const float* __restrict__ costm, const float* __restrict__ costmm,
    const int32_t* __restrict__ codes_k, int n_pad, size_t plane,
    float* __restrict__ S, float* __restrict__ H, int len)
{
    // Column 0 (reference_align.cpp:65-74).
    float out = 0.0f;
    for (int i = 0; i <= len; ++i) {
        const size_t at = (size_t)i * n_pad + n;
        out = (local || i == 0) ? 0.0f : (-go) - ((float)i - 1.0f) * ge;
        S[at] = out;
        H[at] = NEG;
    }

    for (int j = 0; j < rlen; ++j) {
        const bool zero_vgap = local && j == rlen - 1;  // free trailing gaps
        const int m = modes[j] - 1;
        const int mk = mask[j];
        const float* cm = costm + (size_t)m * plane;
        const float* cmm = costmm + (size_t)m * plane;

        float s_up = NEG;  // previous column's S at row i-1
        float cum = NEG;   // running max of B over rows < i
        for (int i = 0; i <= len; ++i) {
            const size_t at = (size_t)i * n_pad + n;
            const float s_old = S[at];
            const float h_old = H[at];
            const int code = codes_k[at];
            const float cost = ((mk >> code) & 1) ? cm[at] : cmm[at];

            const float Hn = fmaxf(s_old - go, h_old - ge);
            const float M = s_up + cost;
            const float mv = fmaxf(M, Hn);
            const float V = zero_vgap ? cum : cum - ((float)i - 1.0f) * ge;
            const float B = zero_vgap ? mv : (mv - go) + (float)i * ge;
            out = fmaxf(mv, V);

            S[at] = out;
            H[at] = Hn;
            s_up = s_old;
            cum = fmaxf(cum, B);
        }
    }
    return out;
}

__device__ int clamp_len(int len, int l1)
{
    return len < 0 ? 0 : (len > l1 - 1 ? l1 - 1 : len);
}

__global__ void score_kernel(
    const int32_t* __restrict__ modes, const int32_t* __restrict__ mask,
    int rlen, float go, float ge, int local,
    const float* __restrict__ costm, const float* __restrict__ costmm,
    const int32_t* __restrict__ codes_k, const int32_t* __restrict__ lengths,
    int n, int l1, int n_pad, float* __restrict__ S, float* __restrict__ H,
    float* __restrict__ out)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    out[t] = score_one(
        t, modes, mask, rlen, go, ge, local != 0, costm, costmm, codes_k,
        n_pad, (size_t)l1 * n_pad, S, H, clamp_len(lengths[t], l1));
}

// seg_i [nseg, 3] = (start, rlen, local); seg_f [nseg, 2] = (go, ge) with
// go already open + extend.  Every lane of n_pad runs; padded lanes carry
// length 0 and so compute row 0 only.
__global__ void segments_kernel(
    const int32_t* __restrict__ modes, const int32_t* __restrict__ mask,
    const int32_t* __restrict__ seg_i, const float* __restrict__ seg_f,
    int nseg, const float* __restrict__ costm, const float* __restrict__ costmm,
    const int32_t* __restrict__ codes_k, const int32_t* __restrict__ lens_k,
    int l1, int n_pad, float* __restrict__ S, float* __restrict__ H,
    float* __restrict__ out)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_pad) return;
    const int len = clamp_len(lens_k[t], l1);
    const size_t plane = (size_t)l1 * n_pad;
    for (int s = 0; s < nseg; ++s) {
        const int start = seg_i[3 * s];
        out[(size_t)s * n_pad + t] = score_one(
            t, modes + start, mask + start, seg_i[3 * s + 1],
            seg_f[2 * s], seg_f[2 * s + 1], seg_i[3 * s + 2] != 0,
            costm, costmm, codes_k, n_pad, plane, S, H, len);
    }
}

constexpr int THREADS = 128;

}  // namespace

extern "C" int sarlacc_score_kernel(
    const int32_t* modes, const int32_t* mask, int rlen, float go, float ge,
    int local, const float* costm, const float* costmm, const int32_t* codes_k,
    const int32_t* lengths, int n, int l1, int n_pad, float* S, float* H,
    float* out, void* stream)
{
    if (n <= 0 || l1 <= 0) return 0;
    const int blocks = (n + THREADS - 1) / THREADS;
    score_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        modes, mask, rlen, go, ge, local, costm, costmm, codes_k, lengths, n,
        l1, n_pad, S, H, out);
    return (int)cudaGetLastError();
}

extern "C" int sarlacc_segments_kernel(
    const int32_t* modes, const int32_t* mask, const int32_t* seg_i,
    const float* seg_f, int nseg, const float* costm, const float* costmm,
    const int32_t* codes_k, const int32_t* lens_k, int l1, int n_pad,
    float* S, float* H, float* out, void* stream)
{
    if (n_pad <= 0 || l1 <= 0 || nseg <= 0) return 0;
    const int blocks = (n_pad + THREADS - 1) / THREADS;
    segments_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        modes, mask, seg_i, seg_f, nseg, costm, costmm, codes_k, lens_k, l1,
        n_pad, S, H, out);
    return (int)cudaGetLastError();
}
