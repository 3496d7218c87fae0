from .build import LAUNCHES, reset_launches
from .ops import attention_op, batched_feasible_op, decode_attention_op, ssd_scan_op
