"""glm4-9b [hf:THUDM/glm-4-9b]

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552 — RoPE, GQA.
GLM specifics: partial rotary (fraction 0.5), QKV bias, untied embeddings.
"""
from repro_torch.models.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    kv_heads=2,
    d_ff=13696,
    vocab=151552,
    head_dim=128,
    norm="rms",
    act="swiglu",
    qkv_bias=True,
    use_rope=True,
    rope_theta=10000.0,
    rope_fraction=0.5,
    tie_embeddings=False,
    remat="full",
)

register(ArchSpec(
    name="glm4-9b",
    family="dense",
    config=CONFIG,
    shapes=dict(LM_SHAPES),
    long_context_ok=False,
    source="hf:THUDM/glm-4-9b",
    notes="long_500k skipped: pure full attention.",
))
