"""Where the demux score path's time goes on the card, stage by stage.

    python -m sarlacc_tpu_torch.tools.profile_demux

Counterpart of ``scripts/profile_demux_tpu.py`` (its inline
``pallas_call`` :122 launches ``pallas_align._kernel``; here that is kernel
C, ``csrc/score_kernel.cu::score_kernel``, launched straight on staged
planes).  100 000 random 250-bp reads from numpy seed 3, the 47-column
adaptor ``ACGCTAGCATCAGTCNNNNCACAGCTACGANNNNNNNNCGTACGCAT`` and adaptor2
(R = 14), as the script.  Sections:

1. upload (``prepare_scores_input``);
2. the full path (plane build + kernel C) per adaptor: first call, then
   steady state, with GCUPS;
3. the [N] score readback;
4. the plane prelude alone (pad, transpose, cost gather:
   ``build_cost_planes``);
5. the pure kernel on pre-staged planes, with GCUPS; its scores must equal
   the full path's;
6. ``barcode_align`` with 12 barcodes on 100 000 observed 12-bp reads:
   first call and steady state;
7. the 4-call demux sequence of ``align_scores_only`` (each with its
   readback), as bench.py's.

Device work is timed with CUDA events, host stages with a synchronised
clock; each line says which.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..api.align_internal import align_scores_only, prepare_adaptor, prepare_scores_input
from ..api.barcode import barcode_align
from ..core.encode import SeqBatch
from ..device import resolve_device
from ..ops.cuda_align import build_cost_planes, encode_mask, fit_scores, plane_dims, score_kernel
from ..ops.align import dp_scores
from .timing import device_label, event_ms, host_s

__all__ = ["ADAPTOR1", "ADAPTOR2", "measure", "pure_kernel"]

ADAPTOR1 = "ACGCTAGCATCAGTCNNNNCACAGCTACGANNNNNNNNCGTACGCAT"
ADAPTOR2 = "TGCATCGATCGCAT"


def pure_kernel(ad, planes, lengths):
    """Kernel C on staged planes (gap open 5, extension 1, fitting mode):
    the launch the script makes by hand; the plain ``dp_scores`` on CPU
    tensors."""
    costm, costmm, codes_k = planes
    args = (ad.modes, encode_mask(ad.matched), 5.0, 1.0, costm, costmm, codes_k)
    if codes_k.is_cuda:
        return score_kernel(*args, lengths, True)
    idx = lengths.to(torch.int64)[None, :]
    return dp_scores(*args, True)[:, : lengths.shape[0]].gather(0, idx)[0]


def measure(N: int = 100_000, L: int = 250, device=None, reps: int = 5, log=print) -> dict:
    dev = resolve_device(device)
    log(f"[profile_demux] {device_label(dev)}")
    clock = "events" if dev.type == "cuda" else "host clock"
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, (N, L)).astype(np.int8)
    quals = rng.integers(20, 60, (N, L)).astype(np.uint8) + 33
    front = SeqBatch(codes, np.full(N, L, dtype=np.int64), quals, None)
    a1 = prepare_adaptor(ADAPTOR1, device=dev)
    a2 = prepare_adaptor(ADAPTOR2, device=dev)
    out: dict = {"N": N, "L": L}

    prep, sec = host_s(lambda: prepare_scores_input(a1, front), dev)
    out["upload_s"] = sec
    log(f"[profile_demux] upload (prepare_scores_input): {sec * 1e3:.1f} ms host")

    full_scores = {}
    for name, ad in (("a1", a1), ("a2", a2)):
        R = len(ad)
        fargs = (prep.codes, prep.qidx, prep.lengths, ad.modes, ad.matched, ad.match_tab,
                 ad.mismatch_tab, 5.0, 1.0, True)
        res, first = host_s(lambda: fit_scores(*fargs), dev)
        ms = event_ms(lambda: fit_scores(*fargs), reps, dev, warmup=False)
        cells = N * L * R
        _, host_steady = host_s(lambda: [fit_scores(*fargs) for _ in range(reps)], dev)
        host_ms = host_steady * 1e3 / reps
        full_scores[name] = res
        _, rb = host_s(lambda: res.cpu().numpy(), dev)
        out[f"full_{name}"] = {"R": R, "first_s": first, "ms": ms, "host_ms": host_ms,
                               "gcups": cells / (ms * 1e-3) / 1e9, "readback_ms": rb * 1e3}
        log(f"[profile_demux] full path {name}(R={R}): first call {first * 1e3:.1f} ms host; "
            f"steady {ms:.3f} ms {clock} ({host_ms:.3f} ms host) -> "
            f"{cells / (ms * 1e-3) / 1e9:.1f} GCUPS")
        log(f"[profile_demux] {name} readback [N] f32: {rb * 1e3:.3f} ms host")

    l1, n_pad = plane_dims(N, L)
    mt = a1.match_tab.to(torch.float32)
    mmt = a1.mismatch_tab.to(torch.float32)
    planes = build_cost_planes(prep.codes, prep.qidx, mt, mmt, l1, n_pad)
    ms = event_ms(lambda: build_cost_planes(prep.codes, prep.qidx, mt, mmt, l1, n_pad), reps, dev)
    out["prelude_ms"] = ms
    log(f"[profile_demux] prelude (pad + transpose + cost gather, l1={l1} n_pad={n_pad}): "
        f"{ms:.3f} ms {clock}")

    lengths = prep.lengths.to(torch.int32).contiguous()
    for name, ad in (("a1", a1), ("a2", a2)):
        R = len(ad)
        got = pure_kernel(ad, planes, lengths)
        if not torch.equal(got, full_scores[name]):
            raise AssertionError(f"pure kernel {name}: scores differ from the full path's")
        ms = event_ms(lambda: pure_kernel(ad, planes, lengths), reps, dev)
        gcups = N * L * R / (ms * 1e-3) / 1e9
        out[f"pure_{name}"] = {"R": R, "ms": ms, "gcups": gcups}
        log(f"[profile_demux] pure kernel {name}(R={R}): {ms:.3f} ms {clock} -> "
            f"{gcups:.1f} GCUPS device (scores equal the full path's)")

    bc_rng = np.random.default_rng(7)
    barcodes = ["".join(bc_rng.choice(list("ACGT"), 12)) for _ in range(12)]
    obs_codes = bc_rng.integers(0, 4, (N, 12)).astype(np.int8)
    obs = SeqBatch(obs_codes, np.full(N, 12, np.int64),
                   bc_rng.integers(53, 93, (N, 12)).astype(np.uint8), None)
    _, first = host_s(lambda: barcode_align(obs, barcodes, device=dev), dev)
    _, steady = host_s(lambda: barcode_align(obs, barcodes, device=dev), dev)
    out["barcode_first_s"], out["barcode_steady_s"] = first, steady
    log(f"[profile_demux] barcode_align 12 barcodes: first {first:.3f} s, steady {steady:.3f} s host")

    pb = prepare_scores_input(a1, front)

    def sequence():
        return [
            align_scores_only(a1, None, 5.0, 1.0, prepared=prep),
            align_scores_only(a2, None, 5.0, 1.0, prepared=pb),
            align_scores_only(a1, None, 5.0, 1.0, prepared=pb),
            align_scores_only(a2, None, 5.0, 1.0, prepared=prep),
        ]

    seq, sec = host_s(sequence, dev)
    if not all(np.isfinite(s).all() and s.shape == (N,) for s in seq):
        raise AssertionError("the 4-call demux sequence gave non-finite scores")
    out["sequence_s"] = sec
    log(f"[profile_demux] 4-call demux sequence (each with its readback): {sec:.3f} s host")
    return out


def main(argv=None) -> int:
    if argv:
        raise SystemExit("usage: python -m sarlacc_tpu_torch.tools.profile_demux")
    measure()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
