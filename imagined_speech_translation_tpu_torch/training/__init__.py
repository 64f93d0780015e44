"""Training: composite loss, three-group fused AdamW, train state, the train
/ eval steps with gradient accumulation, checkpoints and the trainer loop."""

from .losses import (  # noqa: F401
    AdaptiveLossScheduler,
    CompositeLossHeads,
    composite_loss,
    get_top_k_vocab_indices,
    label_smoothed_ce,
)
from .optimizer import (  # noqa: F401
    GROUP_RULES,
    FusedAdamW,
    build_optimizer,
    label_params_by_substring,
    learning_rates_at,
    make_schedule,
)
from .train_state import TrainModule, TrainState, build_train_module, create_train_state  # noqa: F401
from .train_step import make_eval_step, make_loss_fn, make_train_step  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from .trainer import EEGTrainer  # noqa: F401
