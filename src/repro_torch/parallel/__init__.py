from .sharding import (DEFAULT_RULES, PartitionSpec, Rules, ShardingCtx, constrain,
                       divisible)
