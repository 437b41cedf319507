"""grok-1-314b [hf:xai-org/grok-1; unverified]

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts
top-2.  Grok specifics: embedding scale, attention + logits tanh
soft-capping (30.0), GeGLU experts, tied embeddings.
"""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    norm="rms",
    act="geglu",
    use_rope=True,
    rope_theta=10000.0,
    attn_softcap=30.0,
    logits_softcap=30.0,
    embed_scale=True,
    tie_embeddings=True,
    moe=MoEConfig(d_model=6144, d_ff=32768, num_experts=8, top_k=2,
                  capacity_factor=1.25, kind="geglu"),
    remat="full",
)

register(ArchSpec(
    name="grok-1-314b",
    family="moe",
    config=CONFIG,
    shapes=dict(LM_SHAPES),
    long_context_ok=False,
    source="hf:xai-org/grok-1 (unverified tier)",
    notes="long_500k skipped: pure full attention.  1.26 TB of fp32 "
          "params: one card holds it only cut in depth.",
))
