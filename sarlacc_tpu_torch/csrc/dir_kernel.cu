// Kernel A: quality-aware fitting/global affine-gap DP with run-length
// directions, for N reads against one IUPAC reference of R columns.
//
// Replaces sarlacc_tpu/ops/pallas_align.py::_dir_kernel (launched by
// _launch_dirs / fit_dirs_pallas).  Plain PyTorch version:
// sarlacc_tpu_torch/ops/align.py::dp_align; outputs are bit-identical.
//
// Layout: every plane is [l1, n_pad] with reads on the fast axis, so a warp
// reads and writes 32 consecutive reads of one DP row (coalesced).  One
// thread owns one read and walks the reference columns in order, and within
// a column the rows in order: the vertical-gap prefix max, the left-run
// bookkeeping and the up-run jump point all become running scalars, so the
// TPU kernel's log-shift scans and its post-hoc up-run reconstruction turn
// into one pass.  Max is exact, so the serial running max gives the same
// bits as the log-shift scan.
//
// What bounds it: memory traffic.  Per cell the thread reads S, H, the
// left flag, the left jump point, the code and one cost plane, and writes
// S, H, the flag, the jump point and a 2-byte direction: about 30 bytes
// per cell against a few dozen flops, far below the card's ratio of flops
// to bytes.  The design keeps every access coalesced and the per-column
// state in registers; the per-row state stays in device memory (L2 holds
// a block's rows), which is the next thing to move into shared memory.
//
// Exactness: compile with --fmad=false.  The association
// (mv - go) + i*ge and cum - (i-1)*ge must not contract into FMAs, or the
// last bit moves and direction ties flip.  Tie rules follow
// reference_align.cpp:126-174: a gap jump wins only when strictly greater
// (cand >= jump keeps the open), is_diag and is_left are strict.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -3.0e38f;

__global__ void dir_kernel(
    const int32_t* __restrict__ modes, const int32_t* __restrict__ mask,
    int rlen, float go, float ge, int local,
    const float* __restrict__ costm, const float* __restrict__ costmm,
    const int32_t* __restrict__ codes_k, int l1, int n_pad,
    float* __restrict__ S, float* __restrict__ H,
    uint8_t* __restrict__ was_left, int32_t* __restrict__ ljp,
    int16_t* __restrict__ dirs)
{
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= n_pad) return;
    const size_t plane = (size_t)l1 * n_pad;

    // Column 0 (reference_align.cpp:65-74).
    for (int i = 0; i < l1; ++i) {
        const size_t at = (size_t)i * n_pad + n;
        float s = 0.0f;
        if (!local && i > 0) s = (-go) - ((float)i - 1.0f) * ge;
        S[at] = s;
        H[at] = NEG;
        was_left[at] = 0;
        ljp[at] = 0;
    }

    for (int j = 0; j < rlen; ++j) {
        const bool zero_vgap = local && j == rlen - 1;  // free trailing gaps
        const float vgo = zero_vgap ? 0.0f : go;
        const float vge = zero_vgap ? 0.0f : ge;
        const int m = modes[j] - 1;
        const int mk = mask[j];
        const float* cm = costm + (size_t)m * plane;
        const float* cmm = costmm + (size_t)m * plane;
        int16_t* dcol = dirs + (size_t)j * plane;

        float s_up = NEG;     // previous column's S at row i-1
        float cum = NEG;      // running max of B over rows < i
        float sn_prev = NEG;  // this column's S at row i-1
        float v_prev = NEG;   // this column's V at row i-1
        bool up_prev = false;
        int pnt = 0;          // last row < i whose vertical gap did not jump

        for (int i = 0; i < l1; ++i) {
            const size_t at = (size_t)i * n_pad + n;
            const float s_old = S[at];
            const float h_old = H[at];
            const bool wl = was_left[at] != 0;
            const int jp = ljp[at];
            const int code = codes_k[at];
            const float cost = ((mk >> code) & 1) ? cm[at] : cmm[at];

            const float M = s_up + cost;
            const float cand_h = s_old - (wl ? ge : go);
            const float jump_h = h_old - ge;
            const bool cond_h = cand_h >= jump_h;
            const float Hn = cond_h ? cand_h : jump_h;
            const float mv = fmaxf(M, Hn);

            float V = NEG;
            if (i > 0) V = zero_vgap ? cum : cum - ((float)i - 1.0f) * ge;
            const float B = zero_vgap ? mv : (mv - go) + (float)i * ge;
            const float Sn = (i == 0) ? Hn : fmaxf(mv, V);

            const bool is_diag = (M > Hn) && (M > V);
            const bool is_left = !is_diag && (Hn > V);
            const bool is_up = !(is_diag || is_left);

            const int left_step = cond_h ? 1 : 1 + j - jp;
            bool cond_v = true;  // row 0: both candidates are NEG
            if (i > 0) {
                const float cand_v = sn_prev - (up_prev ? vge : vgo);
                cond_v = cand_v >= v_prev - vge;
            }
            const int up_step = cond_v ? 1 : 1 + i - pnt;
            if (cond_v) pnt = i;

            int d = is_diag ? 0 : (is_left ? left_step : -up_step);
            if (i == 0) d = 1;  // row 0 is always a single left step
            dcol[at] = (int16_t)d;

            S[at] = Sn;
            H[at] = Hn;
            was_left[at] = (i == 0 || is_left) ? 1 : 0;
            ljp[at] = cond_h ? j : jp;

            s_up = s_old;
            sn_prev = Sn;
            v_prev = V;
            up_prev = is_up;
            cum = fmaxf(cum, B);
        }
    }
}

}  // namespace

extern "C" int sarlacc_dir_kernel(
    const int32_t* modes, const int32_t* mask, int rlen, float go, float ge,
    int local, const float* costm, const float* costmm, const int32_t* codes_k,
    int l1, int n_pad, float* S, float* H, uint8_t* was_left, int32_t* ljp,
    int16_t* dirs, void* stream)
{
    if (n_pad <= 0 || l1 <= 0) return 0;
    const int threads = 128;
    const int blocks = (n_pad + threads - 1) / threads;
    dir_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        modes, mask, rlen, go, ge, local, costm, costmm, codes_k, l1, n_pad,
        S, H, was_left, ljp, dirs);
    return (int)cudaGetLastError();
}
