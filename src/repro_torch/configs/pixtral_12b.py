"""pixtral-12b [vlm] — 40L d=5120 32H (GQA kv=8) ff=14336 vocab=131072,
pixtral-ViT frontend (STUB: precomputed patch embeddings) + mistral-nemo
backbone [hf:mistralai/Pixtral-12B-2409; unverified]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=128, embed_inputs=True,
).validate()
