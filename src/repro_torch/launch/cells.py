"""Cell builder: (arch x shape x mesh) -> step function + abstract inputs
(``repro.launch.cells``).

A *cell* is one dry-run unit: the step function (the train step for
``train`` shapes, the prefill/decode serve steps for inference shapes), its
inputs as meta-device tensors laid out on the mesh (``DTensor`` s; plain
meta tensors on a trivial mesh), and their placements. Nothing is
allocated: every tensor is on the meta device, and the model runs its plain
attention and SSD scan (``attn_impl="torch"``), as the reference's dry run
takes its plain ``"xla"`` path, or the reference's chunked route
(``attn_impl="chunked"``: online softmax over key chunks and the chunked
SSD scan).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.analysis.cost import Cost, CostCounter
from repro_torch.configs import SHAPES, ShapeSpec, cell_supported, get_config
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import (
    DEFAULT_RULES,
    activation_sharding,
    distribute,
    named_shardings,
    seq_shard_rules,
    to_placements,
)
from repro_torch.models.transformer import shard_params
from repro_torch.serve.step import (
    abstract_cache,
    cache_shardings,
    make_decode_step,
    make_prefill_step,
    shard_tree,
)
from repro_torch.train import AdamW, AdamWConfig, abstract_state, make_train_step, shard_state
from repro_torch.train.step import batch_pspecs, state_shardings

ENC_LEN_STUB = 4096  # encoder frames for enc-dec decode cells (audio stub)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    fn: Callable
    args: tuple
    in_shardings: tuple  # one placements tree an argument (None: not a tensor)
    meta: dict
    rules: dict | None = None


def _abstract_batch(cfg: ModelConfig, shape: ShapeSpec, *, with_labels: bool) -> dict:
    b, s = shape.global_batch, shape.seq_len
    tok_len = s - cfg.frontend_len if cfg.frontend else s
    meta = torch.device("meta")
    batch: dict[str, Any] = {"tokens": torch.empty((b, tok_len), dtype=torch.int32, device=meta)}
    if with_labels:
        batch["labels"] = torch.empty((b, tok_len), dtype=torch.int32, device=meta)
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16, device=meta)
    if cfg.frontend:
        batch["prefix"] = torch.empty((b, cfg.frontend_len, cfg.d_model), dtype=torch.bfloat16,
                                      device=meta)
    return batch


def _batch_shardings(cfg: ModelConfig, mesh, batch: dict, rules) -> dict:
    """Each batch leaf split along its batch dim over (pod, data) when they
    divide it, as the reference's ``_batch_shardings``."""
    ps = batch_pspecs(cfg, mesh, next(iter(batch.values())).shape[0], rules)
    return {k: to_placements(ps[k], mesh) for k in batch}


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    *,
    zero1: bool = False,
    rules: dict | None = None,
    optim=None,
    cfg_overrides: dict | None = None,
    seq_shard_cache: bool = False,
) -> Cell:
    cfg = get_config(arch).replace(attn_impl="torch")
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    if cfg.attn_impl not in ("torch", "chunked"):
        raise ValueError(f"attn_impl {cfg.attn_impl!r}: meta tensors launch no kernel; "
                         "the dry run takes 'torch' or 'chunked'")
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape_name)
    if not ok:
        raise ValueError(f"cell ({arch}, {shape_name}) unsupported: {why}")
    if rules is None:
        rules = seq_shard_rules() if seq_shard_cache else DEFAULT_RULES

    if shape.kind == "train":
        optim = optim or AdamW(AdamWConfig())
        state = shard_state(abstract_state(cfg, optim), cfg, mesh, optim, zero1=zero1,
                            rules=rules)
        batch = _abstract_batch(cfg, shape, with_labels=True)
        b_sh = _batch_shardings(cfg, mesh, batch, rules)
        return Cell(arch, shape, cfg, make_train_step(cfg, optim),
                    (state, shard_tree(batch, mesh, b_sh)),
                    in_shardings=(state_shardings(cfg, mesh, optim, zero1=zero1, rules=rules),
                                  b_sh),
                    meta={"kind": "train", "tokens": shape.global_batch * shape.seq_len},
                    rules=rules)

    params = shard_params(registry.build(cfg, device="meta"), mesh, rules)
    p_sh = named_shardings(registry.abstract_params(cfg), mesh, rules)
    if shape.kind == "prefill":
        batch = _abstract_batch(cfg, shape, with_labels=False)
        b_sh = _batch_shardings(cfg, mesh, batch, rules)
        cache = abstract_cache(cfg, shape.global_batch, shape.seq_len, enc_len=shape.seq_len)
        c_sh = cache_shardings(cfg, cache, mesh, rules, seq_shard=seq_shard_cache)
        return Cell(arch, shape, cfg, make_prefill_step(cfg),
                    (params, shard_tree(batch, mesh, b_sh), shard_tree(cache, mesh, c_sh)),
                    in_shardings=(p_sh, b_sh, c_sh),
                    meta={"kind": "prefill", "tokens": shape.global_batch * shape.seq_len},
                    rules=rules)

    # decode: one new token against a cache of seq_len
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
    t_sh = _batch_shardings(cfg, mesh, {"tokens": tokens}, rules)["tokens"]
    cache = abstract_cache(cfg, shape.global_batch, shape.seq_len, enc_len=ENC_LEN_STUB)
    c_sh = cache_shardings(cfg, cache, mesh, rules, seq_shard=seq_shard_cache)
    pos = shape.seq_len - 1  # the cache's last position: every key is attended
    return Cell(arch, shape, cfg, make_decode_step(cfg),
                (params, distribute(tokens, mesh, t_sh), shard_tree(cache, mesh, c_sh), pos),
                in_shardings=(p_sh, t_sh, c_sh, None),
                meta={"kind": "decode", "tokens": shape.global_batch},
                rules=rules)


def trace_cell(cell: Cell, mesh, *, count: bool = True) -> tuple[Any, Cost | None, float]:
    """One run of the cell's step on its meta inputs under
    ``activation_sharding`` and, with ``count``, the cost counter: the
    counterpart of the reference's ``lower_cell`` (``jax.jit`` + ``lower``,
    which traces the step to the per-partition program that the HLO
    analyzer reads). Returns (the step's outputs, the counts or None, the
    seconds the trace took)."""
    counter = CostCounter() if count else None
    t0 = time.perf_counter()
    with activation_sharding(mesh, cell.rules), torch.set_grad_enabled(
            cell.meta["kind"] == "train"):
        if counter is None:
            out = cell.fn(*cell.args)
        else:
            with counter:
                out = cell.fn(*cell.args)
    return out, (counter.cost if counter else None), time.perf_counter() - t0
