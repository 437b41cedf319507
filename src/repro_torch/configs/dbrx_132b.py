"""dbrx-132b [hf:databricks/dbrx-base; unverified]

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16 experts
top-4 (fine-grained).  LayerNorm, SwiGLU experts, RoPE.
"""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    kv_heads=8,
    d_ff=10752,
    vocab=100352,
    head_dim=128,
    norm="layer",
    act="swiglu",
    use_rope=True,
    rope_theta=500_000.0,
    tie_embeddings=False,
    moe=MoEConfig(d_model=6144, d_ff=10752, num_experts=16, top_k=4,
                  capacity_factor=1.25, kind="swiglu"),
    remat="full",
)

register(ArchSpec(
    name="dbrx-132b",
    family="moe",
    config=CONFIG,
    shapes=dict(LM_SHAPES),
    long_context_ok=False,
    source="hf:databricks/dbrx-base (unverified tier)",
    # expert parallelism: its 16 experts divide the 16-way model axis
    rules_overrides={"experts": "model"},
    notes="long_500k skipped: pure full attention.  528 GB of fp32 "
          "params: one card holds it only cut in depth.",
))
