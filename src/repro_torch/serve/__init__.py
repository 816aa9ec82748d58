"""LM serving: caches, prefill/decode steps and greedy generation."""
from repro_torch.serve.step import generate, make_cache, make_decode_step, make_prefill_step

__all__ = ["generate", "make_cache", "make_decode_step", "make_prefill_step"]
