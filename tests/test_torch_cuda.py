"""The port's hand-written CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one.  The file imports no
JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)  Kernel A
and kernel B must give directions bit-identical and scores equal to their
plain PyTorch versions on the same card, across the shapes each kernel's
launch configuration branches on.
"""

import numpy as np
import pytest
import torch

from sarlacc_tpu_torch.api.align_internal import prepare_adaptor
from sarlacc_tpu_torch.core.encode import SeqBatch
from sarlacc_tpu_torch.ops.align import dp_align, prepare_reads
from sarlacc_tpu_torch.ops.cuda_align import (
    DIR_KERNEL,
    build_cost_planes,
    dir_kernel,
    encode_mask,
    fit_dirs,
    plane_dims,
)
from sarlacc_tpu_torch.ops.cuda_msa import PAIR_KERNEL, banded_pair, banded_pair_plain, pair_kernel

ADAPTOR = "ACGCTAGCATCAGTCNNNNCACAGCTACGANNNNNNNNCGTACGCAT"
ADAPTOR2 = "TGCATCGATCGCAT"
BARCODE = "ACGTTGCACGTA"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _reads(rng, n, maxl):
    seqs, quals = [], []
    for _ in range(n):
        ln = int(rng.integers(0, maxl + 1))
        seqs.append("".join(rng.choice(list("ACGTN"), ln)))
        quals.append("".join(chr(int(c)) for c in rng.integers(33, 90, ln)))
    return SeqBatch.from_strings(seqs, quals)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "ref,local", [(ADAPTOR, True), (ADAPTOR, False), (ADAPTOR2, True), (BARCODE, False)]
)
def test_dir_kernel_matches_plain(cuda_device, ref, local):
    rng = np.random.default_rng(len(ref) + local)
    batch = _reads(rng, 700, 250)
    ad = prepare_adaptor(ref, device=cuda_device)
    codes, qidx, _ = prepare_reads(batch, ad.tables, device=cuda_device)
    l1, n_pad = plane_dims(*codes.shape)
    planes = build_cost_planes(codes, qidx, ad.match_tab, ad.mismatch_tab, l1, n_pad)
    args = (ad.modes, encode_mask(ad.matched), 5.0, 1.0, *planes, local)
    s_k, d_k = dir_kernel(*args)
    s_p, d_p = dp_align(*args)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p)
    assert torch.equal(s_k, s_p)


@pytest.mark.cuda
def test_fit_dirs_launches_kernel_once(cuda_device):
    batch = _reads(np.random.default_rng(1), 40, 60)
    ad = prepare_adaptor(ADAPTOR2, device=cuda_device)
    codes, qidx, lengths = prepare_reads(batch, ad.tables, device=cuda_device)
    before = DIR_KERNEL.launches
    scores, dirs, _ = fit_dirs(
        codes, qidx, lengths, ad.modes, ad.matched, ad.match_tab, ad.mismatch_tab, 5.0, 1.0
    )
    assert DIR_KERNEL.launches == before + 1
    assert scores.is_cuda and dirs.is_cuda and bool(torch.isfinite(scores).all())


def _pairs(rng, P, rows, W, bw):
    LA, LB = rows, rows + 16
    codes_a = rng.integers(0, 5, (P, LA)).astype(np.int8)
    codes_b = rng.integers(0, 5, (P, LB)).astype(np.int8)
    codes_b[:, :LA] = np.where(rng.random((P, LA)) < 0.8, codes_a, codes_b[:, :LA])
    lens_a = rng.integers(rows // 2, LA + 1, P).astype(np.int32)
    lens_b = np.clip(lens_a + rng.integers(-12, 13, P), 1, LB).astype(np.int32)
    diffs = lens_b.astype(np.int64) - lens_a
    lo = (np.minimum(0, diffs) - bw).astype(np.int32)
    hi = (np.maximum(0, diffs) + bw).astype(np.int32)
    assert int((hi - lo).max()) + 1 <= W
    return codes_a, codes_b, lens_a, lens_b, lo, hi - lo


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rows,W",
    # threads = W at W = 32 and 64; 1, 4 and 8 cells a thread at 256, 1024
    # and 2048; 16 cells and >48 KB of shared memory at 4096.
    [(64, 32), (64, 64), (256, 256), (512, 1024), (128, 2048), (64, 4096)],
)
def test_pair_kernel_matches_plain(cuda_device, rows, W):
    rng = np.random.default_rng(rows + W)
    arrays = _pairs(rng, 300, rows, W, bw=min(100, (W - 26) // 2))
    args = [torch.as_tensor(a, device=cuda_device) for a in arrays]
    before = PAIR_KERNEL.launches
    s_k, d_k = banded_pair(*args, 0.0, -1.0, 5.0, 1.0, rows, W)
    assert PAIR_KERNEL.launches == before + 1
    s_p, d_p = banded_pair_plain(*args, 0.0, -1.0, 5.0, 1.0, rows, W)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p)
    assert torch.equal(s_k, s_p)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [96, 8192])
def test_pair_kernel_rejects_bad_width(cuda_device, W):
    args = [torch.as_tensor(a, device=cuda_device) for a in _pairs(np.random.default_rng(2), 4, 64, W, 6)]
    with pytest.raises(ValueError, match="power of two"):
        pair_kernel(*args, 0.0, -1.0, 5.0, 1.0, 64, W)
