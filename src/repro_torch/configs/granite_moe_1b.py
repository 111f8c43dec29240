"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8)
d_ff(expert)=512 vocab=49155, 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

The reference's fields, and no more. The published model also scales its
embeddings, residual branches, attention scores and logits by constant
multipliers; the reference's ``ArchConfig`` has no such fields, so the port
has none either."""
from repro_torch.models.model import ArchConfig

ARCH = ArchConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, kv_heads=8, d_ff=512, vocab=49155,
    n_experts=32, top_k=8, moe_d_ff=512,
)
