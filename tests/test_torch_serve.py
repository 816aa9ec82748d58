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
    # sampling at temperature > 0 is ported: without a generator it is
    # greedy, as the reference without a key; with one it draws valid ids
    greedy = generate(model, CFG, np.zeros((1, 4), np.int32), max_new=2, device="cpu")
    no_gen = generate(model, CFG, np.zeros((1, 4), np.int32), max_new=2, temperature=0.7,
                      device="cpu")
    torch.testing.assert_close(no_gen, greedy)
    drawn = generate(model, CFG, np.zeros((1, 4), np.int32), max_new=2, temperature=0.7,
                     generator=torch.Generator().manual_seed(0), device="cpu")
    assert drawn.shape == greedy.shape and 0 <= int(drawn.min()) <= int(drawn.max()) < CFG.vocab
    with pytest.raises(ValueError, match="model is on"):
        generate(model, CFG, np.zeros((1, 4), np.int32), device="meta")


def test_launch_serve_smoke_on_cpu(capsys):
    out = serve_main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu", "--requests", "3",
                      "--batch", "2", "--prompt-len", "20", "--max-new", "4"])
    assert [o.shape for o in out["outputs"]] == [(2, 24), (1, 24)]
    assert len(out["prefill_ms"]) == 2 and out["decode_tok_per_s"] > 0
    text = capsys.readouterr().out
    assert "[serve] prefill:" in text and "[serve] decode:" in text


@pytest.mark.parametrize("temperature", [0.7, 1.5])
def test_sampling_follows_the_reference_distribution(temperature):
    """Sampling cannot repeat ``jax.random.categorical`` draw for draw; both
    packages' 20,000 draws from the same 8-way logits are held against the
    exact probabilities softmax(logits / T) with a chi-square test."""
    from scipy.stats import chisquare

    from repro.serve.step import _sample as ref_sample
    from repro_torch.serve.step import _sample

    n = 20_000
    logits = np.array([[1.0, 0.5, -0.3, 2.0, 0.0, -1.0, 1.2, 0.3]], np.float32)
    scaled = np.exp(logits[0].astype(np.float64) / temperature)
    probs = scaled / scaled.sum()
    port = _sample(torch.from_numpy(np.repeat(logits, n, 0)), temperature,
                   torch.Generator().manual_seed(0))[:, 0].numpy()
    key = jax.random.PRNGKey(0)
    ref = np.asarray(jax.vmap(lambda i: ref_sample(jnp.asarray(logits), temperature, key, i))(
        jnp.arange(n)))[:, 0, 0]
    for draws in (port, ref):
        counts = np.bincount(draws, minlength=8)
        assert counts.sum() == n and len(counts) == 8
        assert chisquare(counts, probs * n).pvalue > 1e-3
