"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf] 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, SWA window 4096. head_dim=80."""
from repro_torch.models.model import ArchConfig

ARCH = ArchConfig(
    name="h2o-danube-1.8b", family="dense", n_layers=24, d_model=2560,
    n_heads=32, kv_heads=8, d_ff=6912, vocab=32000, window=4096,
)
