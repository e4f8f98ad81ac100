from .store import latest_step, restore_checkpoint, save_checkpoint
