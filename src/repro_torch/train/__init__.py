"""Training substrate: optimizers and the train step, on one card
(``repro.train`` without its sharding and compression names, which come
with the device mesh of a later slice)."""
from repro_torch.train.optim import Adafactor, AdafactorConfig, AdamW, AdamWConfig, cosine_lr
from repro_torch.train.step import (
    cross_entropy,
    init_state,
    loss_fn,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "Adafactor",
    "AdafactorConfig",
    "AdamW",
    "AdamWConfig",
    "cosine_lr",
    "cross_entropy",
    "init_state",
    "loss_fn",
    "make_eval_step",
    "make_train_step",
]
