from .adamw import (LeafShards, OptConfig, OptState, apply_updates, global_norm,
                    init_opt_state, opt_state_specs)
from .schedule import warmup_cosine
