// The column-outer score DP with parts of its per-cell work ablated, for
// attributing its time on the card.  Replaces scripts/microbench_score_ablation.py's
// _kernel_ablate (launched by its _launch, pallas_call at :123).
// Plain PyTorch versions: sarlacc_tpu_torch/tools/score_ablation.py::
// ablated_scores_plain (``full`` is ops/align.py::dp_scores).
//
// The body is a per-read DP that walks the columns outer and keeps S and H
// in [l1, n_pad] device-memory planes (kernel C's design before its row
// tiles; same scores), templated over three ablation flags.  Every variant
// keeps the launch shape, the loop structure and the one-thread-per-read
// layout; each flag removes one suspect of that design (the TPU's
// suspects, the log-shift prefix scan and dynamically indexed VMEM reads,
// have no counterpart here):
//
//   NO_VGAP     the running vertical-gap max ``cum`` is dropped (V = NEG):
//               removes the serial max chain and its ramps;
//   NO_DYNCOST  the cost is (code == 1) ? -0.1 : -1.0 with no cost-plane
//               loads (the JAX ablation's constant): removes one 4-byte
//               load per cell from [4, l1, n_pad] planes;
//   NO_STATE    S and H of every row are read and written at row 0's
//               address: the loads and stores stay but hit L1, which
//               isolates the 16 bytes of row-state traffic per cell.  The
//               row index is ANDed with ``row_mask`` (0 from the wrapper)
//               rather than set to 0: an address the compiler could prove
//               constant would let it keep S and H in registers and drop
//               the loads and stores altogether.
//
// Results of the ablated variants are wrong by design but deterministic,
// and each equals its plain version bit for bit; ``full`` equals kernel C.
// Compile with --fmad=false, as kernel C.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -3.0e38f;
constexpr int THREADS = 128;

template <bool NO_VGAP, bool NO_DYNCOST, bool NO_STATE>
__device__ float score_one(
    int n, const int32_t* __restrict__ modes, const int32_t* __restrict__ mask,
    int rlen, float go, float ge, bool local,
    const float* __restrict__ costm, const float* __restrict__ costmm,
    const int32_t* __restrict__ codes_k, int n_pad, size_t plane,
    float* __restrict__ S, float* __restrict__ H, int len, int row_mask)
{
    float out = 0.0f;
    for (int i = 0; i <= len; ++i) {
        const size_t st = (size_t)(NO_STATE ? (i & row_mask) : i) * n_pad + n;
        out = (local || i == 0) ? 0.0f : (-go) - ((float)i - 1.0f) * ge;
        S[st] = out;
        H[st] = NEG;
    }

    for (int j = 0; j < rlen; ++j) {
        const bool zero_vgap = local && j == rlen - 1;
        const int m = modes[j] - 1;
        const int mk = mask[j];
        const float* cm = costm + (size_t)m * plane;
        const float* cmm = costmm + (size_t)m * plane;

        float s_up = NEG;
        float cum = NEG;
        for (int i = 0; i <= len; ++i) {
            const size_t at = (size_t)i * n_pad + n;
            const size_t st = NO_STATE ? (size_t)(i & row_mask) * n_pad + n : at;
            const float s_old = S[st];
            const float h_old = H[st];
            const int code = codes_k[at];
            float cost;
            if (NO_DYNCOST) {
                cost = (code == 1) ? -0.1f : -1.0f;
            } else {
                cost = ((mk >> code) & 1) ? cm[at] : cmm[at];
            }

            const float Hn = fmaxf(s_old - go, h_old - ge);
            const float M = s_up + cost;
            const float mv = fmaxf(M, Hn);
            float V = NEG;
            if (!NO_VGAP) {
                V = zero_vgap ? cum : cum - ((float)i - 1.0f) * ge;
                const float B = zero_vgap ? mv : (mv - go) + (float)i * ge;
                cum = fmaxf(cum, B);
            }
            out = fmaxf(mv, V);

            S[st] = out;
            H[st] = Hn;
            s_up = s_old;
        }
    }
    return out;
}

template <bool NO_VGAP, bool NO_DYNCOST, bool NO_STATE>
__global__ void ablate_kernel(
    const int32_t* __restrict__ modes, const int32_t* __restrict__ mask,
    int rlen, float go, float ge, int local,
    const float* __restrict__ costm, const float* __restrict__ costmm,
    const int32_t* __restrict__ codes_k, const int32_t* __restrict__ lengths,
    int n, int l1, int n_pad, float* __restrict__ S, float* __restrict__ H,
    float* __restrict__ out, int row_mask)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    int len = lengths[t];
    len = len < 0 ? 0 : (len > l1 - 1 ? l1 - 1 : len);
    out[t] = score_one<NO_VGAP, NO_DYNCOST, NO_STATE>(
        t, modes, mask, rlen, go, ge, local != 0, costm, costmm, codes_k,
        n_pad, (size_t)l1 * n_pad, S, H, len, row_mask);
}

template <bool NO_VGAP, bool NO_DYNCOST, bool NO_STATE>
int launch(
    const int32_t* modes, const int32_t* mask, int rlen, float go, float ge,
    int local, const float* costm, const float* costmm, const int32_t* codes_k,
    const int32_t* lengths, int n, int l1, int n_pad, float* S, float* H,
    float* out, int row_mask, void* stream)
{
    if (n <= 0 || l1 <= 0) return 0;
    const int blocks = (n + THREADS - 1) / THREADS;
    ablate_kernel<NO_VGAP, NO_DYNCOST, NO_STATE><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        modes, mask, rlen, go, ge, local, costm, costmm, codes_k, lengths, n,
        l1, n_pad, S, H, out, row_mask);
    return (int)cudaGetLastError();
}

}  // namespace

// One C entry per variant, each with kernel C's arguments and row_mask.
#define SARLACC_ABLATION_ENTRY(NAME, A, B, C)                                  \
    extern "C" int NAME(                                                       \
        const int32_t* modes, const int32_t* mask, int rlen, float go,         \
        float ge, int local, const float* costm, const float* costmm,          \
        const int32_t* codes_k, const int32_t* lengths, int n, int l1,         \
        int n_pad, float* S, float* H, float* out, int row_mask,               \
        void* stream)                                                          \
    {                                                                          \
        return launch<A, B, C>(modes, mask, rlen, go, ge, local, costm,        \
                               costmm, codes_k, lengths, n, l1, n_pad, S, H,   \
                               out, row_mask, stream);                         \
    }

SARLACC_ABLATION_ENTRY(sarlacc_ablate_full, false, false, false)
SARLACC_ABLATION_ENTRY(sarlacc_ablate_no_vgap, true, false, false)
SARLACC_ABLATION_ENTRY(sarlacc_ablate_no_dyncost, false, true, false)
SARLACC_ABLATION_ENTRY(sarlacc_ablate_neither, true, true, false)
SARLACC_ABLATION_ENTRY(sarlacc_ablate_no_state, false, false, true)
