"""Training substrate: optimizers, the train step and its shardings, and
gradient compression (``repro.train``)."""
from repro_torch.train.compression import (
    compressed_psum,
    compressed_psum_tree,
    compression_ratio,
    make_dp_allreduce,
)
from repro_torch.train.optim import Adafactor, AdafactorConfig, AdamW, AdamWConfig, cosine_lr
from repro_torch.train.step import (
    abstract_state,
    batch_pspecs,
    cross_entropy,
    init_state,
    loss_fn,
    make_eval_step,
    make_train_step,
    shard_state,
    state_pspecs,
    state_shardings,
)

__all__ = [
    "Adafactor",
    "AdafactorConfig",
    "AdamW",
    "AdamWConfig",
    "abstract_state",
    "batch_pspecs",
    "compressed_psum",
    "compressed_psum_tree",
    "compression_ratio",
    "cosine_lr",
    "cross_entropy",
    "init_state",
    "loss_fn",
    "make_dp_allreduce",
    "make_eval_step",
    "make_train_step",
    "shard_state",
    "state_pspecs",
    "state_shardings",
]
