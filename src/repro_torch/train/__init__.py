"""Training substrate: AdamW + schedules (optim), generic step builders
(steps) — the port of ``repro/train``. No ``torch.optim``: the optimizer
is written out, in the reference's arithmetic."""

from repro_torch.train.optim import OptConfig, adamw_init, adamw_update, schedule
from repro_torch.train.steps import init_train_state, make_eval_step, make_train_step

__all__ = ["OptConfig", "adamw_init", "adamw_update", "schedule",
           "init_train_state", "make_eval_step", "make_train_step"]
