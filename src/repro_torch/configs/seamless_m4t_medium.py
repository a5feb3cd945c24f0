"""seamless-m4t-medium [audio] — 12L enc + 12L dec, d=1024 16H (kv=16)
ff=4096 vocab=256206; enc-dec multimodal, frontend STUB provides frame
embeddings [arXiv:2308.11596; hf].  Best-fit arch for the paper's delta
technique: speech frames are temporally smooth."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, n_enc_layers=12, n_dec_layers=12, embed_inputs=True,
    delta_applicable=True,
).validate()
