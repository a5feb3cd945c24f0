"""mamba2-130m [ssm] — 24L d=768 (attn-free) vocab=50280, ssm_state=128,
SSD state-space duality [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    delta_applicable=True, subquadratic=True,
).validate()
