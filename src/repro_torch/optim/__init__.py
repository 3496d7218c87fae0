from .adamw import OptConfig, OptState, apply_updates, global_norm, init_opt_state
from .schedule import warmup_cosine
