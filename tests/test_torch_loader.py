"""The port's data pipeline (``repro_torch.data``) against the JAX
package's, on the CPU: the synthetic token stream bit for bit, and the
region-template loader's batches through the port's DMS equal to its
source's, as tensors on the asked device."""
import itertools

import numpy as np
import pytest
import torch

from repro.data import SyntheticTokens as JSyntheticTokens
from repro_torch.core import BoundingBox
from repro_torch.data import RegionTemplateLoader, SyntheticTokens
from repro_torch.storage import DistributedMemoryStorage


@pytest.mark.parametrize("vocab,seq,batch,seed,branching", [
    (512, 128, 8, 0, 4), (151936, 64, 2, 3, 4), (97, 17, 3, 11, 2)])
def test_synthetic_tokens_equal_the_reference_bit_for_bit(vocab, seq, batch, seed, branching):
    mine = SyntheticTokens(vocab, seq, batch, seed=seed, branching=branching, num_steps=4)
    ref = JSyntheticTokens(vocab, seq, batch, seed=seed, branching=branching, num_steps=4)
    got, want = list(mine), list(ref)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for key in ("tokens", "labels"):
            assert g[key].dtype == w[key].dtype == np.int32
            np.testing.assert_array_equal(g[key], w[key])
    np.testing.assert_array_equal(mine.batch_at(7)["tokens"], ref.batch_at(7)["tokens"])


def _dms(batch: int, seq: int) -> DistributedMemoryStorage:
    return DistributedMemoryStorage(BoundingBox((0, 0), (batch, seq)), (batch, seq),
                                    num_servers=2, name="DATA_DMS")


def test_loader_batches_equal_the_source_on_the_asked_device():
    source = SyntheticTokens(300, 24, 4, seed=2, num_steps=6)
    dms = _dms(4, 24)
    loader = RegionTemplateLoader(source, dms, stage_ahead=2, device_prefetch=2, device="cpu")
    got = list(itertools.islice(iter(loader), 6))
    loader.close()
    assert len(got) == 6
    for step, batch in enumerate(got):
        want = source.batch_at(step)
        for key in ("tokens", "labels"):
            t = batch[key]
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), want[key])
    # consumed regions are retired from the store
    assert dms.query("data", "tokens") == [] and dms.query("data", "labels") == []


def test_loader_surfaces_a_producer_failure():
    def broken():
        yield SyntheticTokens(50, 8, 2, seed=0).batch_at(0)
        raise OSError("source lost")

    loader = RegionTemplateLoader(broken(), _dms(2, 8), device="cpu")
    got = []
    with pytest.raises(RuntimeError, match="data producer failed") as info:
        for batch in loader:  # the failure may overtake the staged batch
            got.append(batch)
    assert len(got) <= 1 and isinstance(info.value.__cause__, OSError)
    loader.close()


def test_loader_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    loader = RegionTemplateLoader(SyntheticTokens(50, 8, 2, num_steps=1), _dms(2, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(iter(loader))
    loader.close()
