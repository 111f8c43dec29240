"""deepseek-v3-671b [moe]: MLA + 256-expert top-8 MoE + MTP.
[arXiv:2412.19437; hf] 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280; 1 shared + 256 routed top-8; first 3 layers dense
(d_ff 18432 = 9 * 2048); MTP depth 1."""
from repro_torch.models.model import ArchConfig

ARCH = ArchConfig(
    name="deepseek-v3-671b", family="mla_moe", n_layers=61, d_model=7168,
    n_heads=128, kv_heads=128, d_ff=2048, vocab=129280,
    n_experts=256, top_k=8, moe_d_ff=2048, n_shared=1, shared_d_ff=2048,
    dense_layers=3, mla=True, q_lora=1536, kv_lora=512,
    d_nope=128, d_rope=64, d_v=128, mtp=True,
)
