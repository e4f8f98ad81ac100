from .adam import adam_init, adam_step
from .schedules import (constant_lr, inv_sqrt_lr, step_decay_lr,
                        warmup_then_step_lr)
from .sgd import apply_update, sgd_init, sgd_step
