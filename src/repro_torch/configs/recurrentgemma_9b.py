"""recurrentgemma-9b [hybrid] — 38L d=4096 16H (MQA kv=1) ff=12288
vocab=256000; RG-LRU + local attention 1:2 (pattern R,R,A)
[arXiv:2402.19427; unverified].  Gated linear recurrence: the closest
assigned analogue of the paper's target workload."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab=256000, head_dim=256, block_pattern=("rglru", "rglru", "attn"),
    attn_window=2048, lru_width=4096,
    delta_applicable=True, subquadratic=True,
).validate()
