"""Batched consensus calling on the device (plain PyTorch).

Counterpart of ``sarlacc_tpu/ops/consensus.py`` (flat layout): batches of
MSAs travel as one concatenated byte stream plus ``(gstart, widths,
naligns)`` descriptors, are re-padded on the device by a gather
(:func:`_expand_flat`), tallied per column, and come back as consensus
bases plus Phred+33 chars.  Both modes reproduce create_consensus.cpp:

* **basic** (:61-135): A/C/G/T counts with a separate incidence count ('-'
  absent, 'N' present-but-uncounted); consensus = first max count;
  err = log1p(-(max + pseudo/4) / (total + pseudo)), in float32 as the JAX
  path computes it.
* **quality** (:178-272): per-base log-prob sums with right = log1p(-eps),
  wrong = log(eps/3), eps clamped to [1e-8, 0.99999999], in float64;
  consensus = first argmax; the error accumulates R's ``log1pexp`` over the
  four sums in ascending order (:250-268).

Sums over group members run in member order, one add per member, so every
device adds the same float64 values in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "consensus_basic_flat",
    "consensus_quality_flat",
    "log1pexp",
    "quality_lut",
]

MAX_ERROR = 0.99999999
MIN_ERROR = 0.00000001


def log1pexp(x: torch.Tensor) -> torch.Tensor:
    """R's log1pexp piecewise evaluation (create_consensus.cpp:8-12 via Rmath)."""
    return torch.where(
        x <= -37.0,
        torch.exp(x),
        torch.where(
            x <= 18.0,
            torch.log1p(torch.exp(torch.clamp(x, max=18.0))),
            torch.where(x <= 33.3, x + torch.exp(-torch.clamp(x, min=18.0)), x),
        ),
    )


def _member_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 (group members) strictly in member order."""
    acc = torch.zeros_like(x[:, 0])
    for g in range(x.shape[1]):
        acc = acc + x[:, g]
    return acc


def _basic_core(codes, naligns, min_cov: float, pseudo_count: float):
    f32 = torch.float32
    onehot = (codes[..., None] == torch.arange(4, device=codes.device)).to(f32)
    counts = onehot.sum(dim=1)  # [B, W, 4], exact small integers
    incidences = (codes != 5).sum(dim=1)  # '-' and padding excluded

    keep = incidences.to(f32) >= naligns[:, None].to(f32) * min_cov
    best = torch.argmax(counts, dim=-1).to(torch.int8)  # first max
    maxed = counts.amax(dim=-1)
    total = counts.sum(dim=-1)
    err = torch.log1p(-(maxed + pseudo_count / 4.0) / (total + pseudo_count))
    return keep, best, err


def _quality_core(codes, eps, naligns, min_cov: float):
    dtype = eps.dtype
    is_base = codes < 4  # A/C/G/T add right to their own base
    # Unknown characters (encoded 6) score `wrong` against every base — the
    # quality mode never rejects them (create_consensus.cpp:229-232).
    scoring = is_base | (codes == 6)
    present = codes != 5  # N also counts toward incidence

    e = torch.clamp(eps, MIN_ERROR, MAX_ERROR)
    right = torch.log1p(-e)
    wrong = torch.log(e / 3.0)

    zero = torch.zeros((), dtype=dtype, device=eps.device)
    wrong_sum = _member_sum(torch.where(scoring, wrong, zero))  # [B, W]
    onehot = (codes[..., None] == torch.arange(4, device=codes.device)).to(dtype)
    delta = _member_sum(onehot * torch.where(is_base, right - wrong, zero)[..., None])
    scores = wrong_sum[..., None] + delta  # [B, W, 4]

    incidences = present.sum(dim=1)
    keep = incidences.to(dtype) >= naligns[:, None].to(dtype) * min_cov
    best = torch.argmax(scores, dim=-1).to(torch.int8)  # first max

    # Incremental logsumexp in ascending order (create_consensus.cpp:250-268).
    v = torch.sort(scores, dim=-1).values
    d = v[..., 0]
    d = d + log1pexp(v[..., 1] - d)
    err_num = d + log1pexp(v[..., 2] - d)
    d_all = err_num + log1pexp(v[..., 3] - err_num)
    return keep, best, err_num - d_all


def _phred_chars(err: torch.Tensor) -> torch.Tensor:
    """Natural-log error -> Phred+33 char codes (create_consensus.cpp:18-32;
    std::round == floor(x + 0.5) for the non-negative operand)."""
    ln10 = torch.log(torch.tensor(10.0, dtype=err.dtype, device=err.device))
    to_ascii = torch.clamp(torch.floor(-10.0 * err / ln10 + 0.5), max=93.0)
    return (to_ascii + 33.0).to(torch.uint8)


def _expand_flat(flat, gstart, widths, naligns, G: int, W: int, fill):
    """[F] flat member-major stream -> padded [B, G, W] plane via gather.

    Group k's member m occupies flat[gstart[k] + m*widths[k] : +widths[k]];
    cells outside (padded members/columns) take ``fill``.
    """
    dev = flat.device
    m = torch.arange(G, dtype=torch.int64, device=dev)[None, :, None]
    c = torch.arange(W, dtype=torch.int64, device=dev)[None, None, :]
    wk = widths.to(torch.int64)[:, None, None]
    idx = gstart.to(torch.int64)[:, None, None] + m * wk + c
    valid = (m < naligns.to(torch.int64)[:, None, None]) & (c < wk)
    vals = flat[idx.clamp(0, flat.shape[0] - 1)]
    return torch.where(valid, vals, torch.tensor(fill, dtype=flat.dtype, device=dev))


def consensus_basic_flat(
    flat_codes, gstart, widths, naligns, min_cov, pseudo_count, G: int, W: int
):
    """Flat-layout basic consensus: returns (keep, best, qchar [B, W] uint8)."""
    codes = _expand_flat(flat_codes, gstart, widths, naligns, G, W, 5)
    keep, best, err = _basic_core(codes, naligns, float(min_cov), float(pseudo_count))
    return keep, best, _phred_chars(err)


def consensus_quality_flat(
    flat_codes, flat_quals, lut, gstart, widths, naligns, min_cov, G: int, W: int
):
    """Flat-layout quality consensus.

    ``flat_quals`` carries raw quality char codes (255 at gaps and padding);
    ``lut`` [256] float64 maps char code -> error probability with
    lut[255] = 0.5.
    """
    codes = _expand_flat(flat_codes, gstart, widths, naligns, G, W, 5)
    q = _expand_flat(flat_quals, gstart, widths, naligns, G, W, 255)
    eps = lut[q.to(torch.int64)]
    keep, best, err = _quality_core(codes, eps, naligns, float(min_cov))
    return keep, best, _phred_chars(err)


def quality_lut(encoding) -> np.ndarray:
    """256-entry char-code -> error-probability table (float64).

    Entries below the encoding offset are never gathered (the host validates
    chars >= offset first); index 255 is the gap/no-quality sentinel -> 0.5.
    """
    lut = np.full(256, 0.5, np.float64)
    codes = np.arange(encoding.offset, 255)
    lut[codes] = encoding.errors[
        np.minimum(codes - encoding.offset, encoding.size - 1)
    ]
    return lut
