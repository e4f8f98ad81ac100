from .schedules import constant_lr, inv_sqrt_lr
