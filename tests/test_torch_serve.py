"""The port's LM serving (greedy generation, the launch driver) against the
JAX package and against itself, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JModelConfig
from repro.models import registry as jregistry
from repro.models import spec as jspec
from repro.serve import generate as jgenerate
from repro_torch import convert
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import HybridLM, ModelConfig
from repro_torch.serve import generate

BASE = dict(name="h", family="hybrid", num_layers=3, d_model=64, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=128, vocab=128, window=8,
            num_global_layers=1, ssm_state=8, ssm_headdim=16, remat="none")
JCFG = JModelConfig(param_dtype=jnp.float32, compute_dtype=jnp.float32, **BASE)
CFG = ModelConfig(param_dtype=torch.float32, compute_dtype=torch.float32, **BASE)


@pytest.fixture(scope="module")
def model():
    return HybridLM(CFG, device="cpu", seed=0)


@pytest.mark.parametrize("s0", [5, 12])
def test_greedy_generate_matches_reference(s0):
    """Identical tokens from the same weights, prompts below and above the window."""
    jparams = jspec.materialize(jax.random.key(3), jregistry.abstract_params(JCFG))
    tmodel = convert.lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jparams),
                                              CFG, device="cpu")
    prompt = np.random.default_rng(s0).integers(0, CFG.vocab, (2, s0)).astype(np.int32)
    want = np.asarray(jgenerate(jparams, JCFG, jnp.asarray(prompt), max_new=6))
    got = generate(tmodel, CFG, prompt, max_new=6, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generation_deterministic(model):
    prompt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    a = generate(model, CFG, prompt, max_new=6, device="cpu")
    b = generate(model, CFG, prompt, max_new=6, device="cpu")
    assert torch.equal(a, b)
    assert tuple(a.shape) == (1, 10)


def test_generation_continuation_consistency(model):
    """Generating 6 tokens equals generating 3 then continuing with 3."""
    prompt = np.asarray([[5, 6, 7]], np.int32)
    full = generate(model, CFG, prompt, max_new=6, max_len=16, device="cpu").numpy()
    half = generate(model, CFG, prompt, max_new=3, max_len=16, device="cpu").numpy()
    cont = generate(model, CFG, full[:, :6], max_new=3, max_len=16, device="cpu").numpy()
    np.testing.assert_array_equal(full[:, :6], np.concatenate([prompt, half[:, 3:]], 1))
    np.testing.assert_array_equal(full, cont)


def test_generate_reports_stage_times_and_refuses_sampling(model):
    stats = {}
    generate(model, CFG, np.zeros((1, 4), np.int32), max_new=2, device="cpu", stats=stats)
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    with pytest.raises(NotImplementedError, match="temperature"):
        generate(model, CFG, np.zeros((1, 4), np.int32), max_new=2, temperature=0.7,
                 device="cpu")
    with pytest.raises(ValueError, match="model is on"):
        generate(model, CFG, np.zeros((1, 4), np.int32), device="meta")


def test_launch_serve_smoke_on_cpu(capsys):
    out = serve_main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu", "--requests", "3",
                      "--batch", "2", "--prompt-len", "20", "--max-new", "4"])
    assert [o.shape for o in out["outputs"]] == [(2, 24), (1, 24)]
    assert len(out["prefill_ms"]) == 2 and out["decode_tok_per_s"] > 0
    text = capsys.readouterr().out
    assert "[serve] prefill:" in text and "[serve] decode:" in text
