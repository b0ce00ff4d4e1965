// Kernel C with parts of its cell body ablated, for attributing its time on
// the card.  Replaces scripts/microbench_score_ablation.py's _kernel_ablate
// (launched by its _launch, pallas_call at :123).  Plain PyTorch versions:
// sarlacc_tpu_torch/tools/score_ablation.py::ablated_scores_plain.
//
// There is no DP here: each entry launches kernel C's own template
// (score_kernel<TOP, F> of csrc/score_kernel.cu, included below with its
// kernel D and entry points left out) with one set of ablation flags, at
// kernel C's launch shape: 128 threads a block, one read a thread, the tile
// width the wrapper picks from R, C's __launch_bounds__, and C's hand-off
// scratch for references wider than one tile.  The variants:
//
//   full        no flag: kernel C itself, bit for bit and launch for launch;
//   no_vgap     NO_VGAP: the columns' running vertical-gap max dropped;
//   no_dyncost  NO_DYNCOST: one cost a row from the code, no cost slot read;
//   neither     both;
//   no_rowload  NO_ROWLOAD: every row's code and costs fetched from row
//               (i & row_mask), 0 from the wrapper, so C's only
//               device-memory traffic hits L1.
//
// Scores of the ablated variants are wrong by design but deterministic, and
// each equals its plain version bit for bit.  Compile with --fmad=false, as
// kernel C.

#define SCORE_BODY_ONLY
#include "score_kernel.cu"

// One C entry a variant: kernel C's arguments, then row_mask (read only by
// no_rowload).  A CUDA error code (0 on success); a tile width other than
// 15, 31 or 63 is refused (cudaErrorInvalidValue).
#define SARLACC_ABLATION_ENTRY(NAME, FLAGS)                                      \
    extern "C" int NAME(                                                         \
        const int32_t* modes, const int32_t* mask, int rlen, float go,           \
        float ge, int local, const float* costm, const float* costmm,            \
        const int32_t* codes_k, const int32_t* lengths, int n, int l1,           \
        int n_pad, int tj, float* scratch, float* out, int row_mask,             \
        void* stream)                                                            \
    {                                                                            \
        return launch_score<FLAGS>(modes, mask, rlen, go, ge, local, costm,      \
                                   costmm, codes_k, lengths, n, l1, n_pad, tj,   \
                                   scratch, out, nullptr, row_mask, stream);     \
    }

SARLACC_ABLATION_ENTRY(sarlacc_ablate_full, 0)
SARLACC_ABLATION_ENTRY(sarlacc_ablate_no_vgap, NO_VGAP)
SARLACC_ABLATION_ENTRY(sarlacc_ablate_no_dyncost, NO_DYNCOST)
SARLACC_ABLATION_ENTRY(sarlacc_ablate_neither, NO_VGAP | NO_DYNCOST)
SARLACC_ABLATION_ENTRY(sarlacc_ablate_no_rowload, NO_ROWLOAD)

// Resources of the variant with ablation flags ``flags`` at tile width tj,
// as sarlacc_score_attrs gives kernel C's; other flags are refused.
extern "C" int sarlacc_ablation_attrs(int flags, int tj, int* out)
{
    switch (flags) {
    case 0: return kernel_attrs(score_kernel_for<0>(tj), out);
    case NO_VGAP: return kernel_attrs(score_kernel_for<NO_VGAP>(tj), out);
    case NO_DYNCOST: return kernel_attrs(score_kernel_for<NO_DYNCOST>(tj), out);
    case NO_VGAP | NO_DYNCOST: return kernel_attrs(score_kernel_for<NO_VGAP | NO_DYNCOST>(tj), out);
    case NO_ROWLOAD: return kernel_attrs(score_kernel_for<NO_ROWLOAD>(tj), out);
    default: return (int)cudaErrorInvalidValue;
    }
}
