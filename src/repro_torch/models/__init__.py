from .config import ModelConfig, torch_dtype
from . import model, frontends
from .model import (init, apply, loss_fn, lm_loss, logits, init_cache,
                    decode_step)
