from .flash_attention import LAUNCHES, reset_launches
from .ops import attention_op, decode_attention_op
