"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified]

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072 — pixtral-ViT +
mistral-nemo backbone.  head_dim=128 (q/k/v project to 4096).

The ViT frontend is a stub, as in the JAX package: precomputed patch
embeddings (B, 256, d_model) are prepended to the token sequence, and
the loss is computed on the text positions only.
"""
from repro_torch.models.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    norm="rms",
    act="swiglu",
    use_rope=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    frontend_embeds=True,
    remat="full",
)

register(ArchSpec(
    name="pixtral-12b",
    family="vlm",
    config=CONFIG,
    shapes=dict(LM_SHAPES),
    long_context_ok=False,
    source="hf:mistralai/Pixtral-12B-2409 (unverified tier)",
    notes="long_500k skipped: pure full attention.  ViT frontend stubbed "
          "(precomputed patch embeddings).",
))
