"""Training substrate, after ``repro.training``: AdamW (``optim``),
gradient compression (``compress``) and the straggler watchdog
(``watchdog``)."""
from repro_torch.training.optim import (
    AdamWConfig, TrainState, adamw_init, adamw_update, clip_by_global_norm,
    schedule, train_state_init,
)
from repro_torch.training.watchdog import Watchdog

__all__ = ["AdamWConfig", "TrainState", "Watchdog", "adamw_init",
           "adamw_update", "clip_by_global_norm", "schedule",
           "train_state_init"]
