"""PyTorch port, utilities: stage checkpoints and the stage profiler.

A Frame saved by either package loads in the other (the file is the same
byte for byte), the profiler counts as the JAX one does, and the device
library's pair stage records the same pairs and DP cells as JAX's.
"""

import os

import numpy as np
import pytest
import torch

from sarlacc_tpu.core.encode import SeqBatch as JSeqBatch
from sarlacc_tpu.core.frame import Frame as JFrame
from sarlacc_tpu.ops.msa import pair_maps_device as jax_pair_maps_device
from sarlacc_tpu.utils import load_frame as jax_load_frame
from sarlacc_tpu.utils import save_frame as jax_save_frame
from sarlacc_tpu.utils import profiling as jax_profiling
from sarlacc_tpu_torch import device as port_device
from sarlacc_tpu_torch.core.encode import SeqBatch
from sarlacc_tpu_torch.core.frame import Frame
from sarlacc_tpu_torch.ops.msa import pair_maps_device
from sarlacc_tpu_torch.utils import PipelineProfiler, load_frame, save_frame
from sarlacc_tpu_torch.utils import profiling


def _frame(frame_cls, batch_cls):
    """tests/test_utils.py's frame, built from one package's classes."""
    inner = frame_cls(score=np.arange(3.0), start=np.arange(3, dtype=np.int32))
    inner.metadata = {"sequence": "ACGT", "gapOpening": 5}
    batch = batch_cls.from_strings(["AC", "GGT", "T"], ["II", "JJJ", "K"], ["a", "b", "c"])
    return frame_cls(
        {"w": np.asarray([10, 20, 30]), "sub": inner, "seqs": batch,
         "labels": ["x", "y", "z"]},
        metadata={"filepath": "/tmp/x.fastq", "tolerance": 250,
                  "trans": np.eye(4, dtype=np.int64)},
        rownames=["r1", "r2", "r3"],
    )


def _check(g):
    assert len(g) == 3 and g.rownames == ["r1", "r2", "r3"]
    assert np.array_equal(g["w"], [10, 20, 30])
    assert g["labels"] == ["x", "y", "z"]
    assert g["sub"].metadata == {"sequence": "ACGT", "gapOpening": 5}
    assert np.array_equal(g["sub"]["score"], np.arange(3.0))
    assert np.array_equal(g["sub"]["start"], np.arange(3, dtype=np.int32))
    assert g["seqs"].seq_strings() == ["AC", "GGT", "T"]
    assert g["seqs"].qual_strings() == ["II", "JJJ", "K"]
    assert g["seqs"].names == ["a", "b", "c"]
    assert g.metadata["tolerance"] == 250 and g.metadata["filepath"] == "/tmp/x.fastq"
    assert np.array_equal(g.metadata["trans"], np.eye(4, dtype=np.int64))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax", "port_to_port"])
def test_frame_roundtrip_between_packages(tmp_path, direction):
    src, dst = direction.split("_to_")
    save, frame = {
        "jax": (jax_save_frame, _frame(JFrame, JSeqBatch)),
        "port": (save_frame, _frame(Frame, SeqBatch)),
    }[src]
    load, frame_cls = {"jax": (jax_load_frame, JFrame), "port": (load_frame, Frame)}[dst]
    fp = os.path.join(tmp_path, "frame.npz")
    save(frame, fp)
    g = load(fp)
    assert isinstance(g, frame_cls)
    _check(g)


def test_frame_files_are_identical(tmp_path):
    jp, pp = os.path.join(tmp_path, "jax.npz"), os.path.join(tmp_path, "port.npz")
    jax_save_frame(_frame(JFrame, JSeqBatch), jp)
    save_frame(_frame(Frame, SeqBatch), pp)
    with open(jp, "rb") as a, open(pp, "rb") as b:
        assert a.read() == b.read()


def test_profiler():
    p = PipelineProfiler()
    with p.stage("align", items=100, cells=1000):
        pass
    with p.stage("align", items=50):
        pass
    st = p.stages["align"]
    assert st.calls == 2 and st.items == 150 and st.cells == 1000
    assert st.seconds >= 0.0 and st.gcups >= 0.0
    rep = p.report()
    assert "align" in rep and rep.splitlines()[-1].startswith("memory budgets")


def test_profiler_decorator_and_global(monkeypatch):
    fresh = PipelineProfiler()
    monkeypatch.setattr(profiling, "_GLOBAL", fresh)
    assert profiling.get_profiler() is fresh

    @profiling.profiled("twice")
    def f(x):
        return x + 1

    assert f(1) == 2 and f(2) == 3
    with profiling.profiler("inner", items=3):
        pass
    assert fresh.stages["twice"].calls == 2 and fresh.stages["inner"].items == 3
    other = PipelineProfiler()
    profiling.set_profiler(other)
    assert profiling.get_profiler() is other


def test_budgets_are_reported_by_name():
    assert port_device.memory_budget(torch.device("cpu"), 0.5, 12345, "probe") == 12345
    assert "probe=0.00 GiB (cpu)" in port_device.budget_report()


def test_pair_maps_device_records_the_same_stage_counts(monkeypatch):
    """Pairs and DP cells on ``msa.pair_library``, as the JAX package counts
    them, over pairs that fall into three (rows, width) buckets."""
    rng = np.random.default_rng(6)
    lengths = np.concatenate([rng.integers(40, 60, 4), rng.integers(100, 140, 4), [300]])
    codes = rng.integers(0, 4, (lengths.size, int(lengths.max()))).astype(np.int8)
    ga = np.asarray([0, 1, 4, 5, 2, 6, 8])
    gb = np.asarray([1, 2, 5, 7, 3, 8, 0])
    jax_prof, port_prof = jax_profiling.PipelineProfiler(), PipelineProfiler()
    monkeypatch.setattr(jax_profiling, "_GLOBAL", jax_prof)
    monkeypatch.setattr(profiling, "_GLOBAL", port_prof)
    jax_pair_maps_device(codes, lengths, ga, gb, 0.0, -1.0, 5.0, 1.0, 20)
    pair_maps_device(codes, lengths, ga, gb, 0.0, -1.0, 5.0, 1.0, 20, torch.device("cpu"))
    want, got = jax_prof.stages["msa.pair_library"], port_prof.stages["msa.pair_library"]
    assert (got.items, got.cells) == (want.items, want.cells) and got.items == ga.size
    assert got.cells > 0
