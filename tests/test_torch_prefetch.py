"""The port's 3-phase prefetch pipeline (paper S3.2.1) on the CPU, the
cases of ``tests/test_prefetch.py``; on the CPU every phase runs
synchronously. ``tests/test_torch_cuda.py`` runs it over CUDA streams."""
import numpy as np
import pytest
import torch

from repro_torch.runtime import DevicePipeline, prefetch_to_device


def test_prefetch_preserves_order_and_values():
    batches = [{"x": np.full((4,), i, np.float32)} for i in range(10)]
    out = list(prefetch_to_device(iter(batches), depth=3, device="cpu"))
    assert len(out) == 10
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor)
        assert float(b["x"][0]) == i


def test_device_pipeline_overlap_window():
    pipe = DevicePipeline(lambda b: {"y": b["x"] * 2}, window=3, device="cpu")
    batches = [{"x": np.full((8,), i, np.float32)} for i in range(7)]
    outs = list(pipe.map(iter(batches)))
    assert len(outs) == 7
    assert all(isinstance(o["y"], np.ndarray) for o in outs)
    assert all(float(o["y"][0]) == 2 * i for i, o in enumerate(outs))
    assert pipe.stats == {"uploaded": 7, "computed": 7, "downloaded": 7}


def test_device_pipeline_map_tagged_pairs_metadata_with_results():
    # tags are not tensors (tuples of strings); they must bypass the upload
    # and come back paired with their own batch's result
    pipe = DevicePipeline(lambda b: b + 1, window=2, device="cpu", host_fn=lambda a: a * 10)
    tagged = ((("tag", i), np.full((4,), i, np.float32)) for i in range(5))
    outs = list(pipe.map_tagged(tagged))
    assert [t for t, _ in outs] == [("tag", i) for i in range(5)]
    for (_, i), arr in outs:
        assert isinstance(arr, np.ndarray)
        assert float(arr[0]) == (i + 1) * 10
    assert pipe.stats == {"uploaded": 5, "computed": 5, "downloaded": 5}


def test_pipelines_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePipeline(lambda b: b)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePipeline(lambda b: b, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter([np.zeros(2)])))
