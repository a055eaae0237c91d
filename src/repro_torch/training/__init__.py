from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update, adamw_update_,
                                            clip_by_global_norm,
                                            cosine_schedule)
from repro_torch.training.state import TrainState
from repro_torch.training.loop import make_train_step, train_loop

__all__ = ["AdamWState", "TrainState", "adamw_init", "adamw_update",
           "adamw_update_", "clip_by_global_norm", "cosine_schedule",
           "make_train_step", "train_loop"]
