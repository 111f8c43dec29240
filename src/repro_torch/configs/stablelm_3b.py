"""stablelm-3b [dense]: 32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304
[hf:stabilityai/stablelm family]. LayerNorm + 25% partial rotary (carried
as ``rope_pct``, which the reference never reads: rotary runs over the
whole head, head_dim=80)."""
from repro_torch.models.model import ArchConfig

ARCH = ArchConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, kv_heads=32, d_ff=6912, vocab=50304,
    norm="layer", rope_pct=0.25,
)
