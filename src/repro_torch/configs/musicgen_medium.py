"""musicgen-medium [arXiv:2306.05284; hf:facebook/musicgen-medium]

48L d_model=1536 24H (kv=24, MHA) d_ff=6144 vocab=2048 — decoder-only
over EnCodec tokens, 4 parallel codebooks (summed embeddings, one output
head per codebook).

The EnCodec frontend is a stub, as in the JAX package: inputs are the
token grids themselves, (B, S, 4) int32.  Positional encoding is RoPE
where MusicGen's is sinusoidal, as in the JAX package.
"""
from repro_torch.models.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    kv_heads=24,
    d_ff=6144,
    vocab=2048,
    head_dim=64,
    norm="layer",
    act="gelu",
    mlp_bias=True,
    use_rope=True,
    tie_embeddings=False,
    codebooks=4,
    remat="full",
)

register(ArchSpec(
    name="musicgen-medium",
    family="audio",
    config=CONFIG,
    shapes=dict(LM_SHAPES),
    long_context_ok=False,
    source="arXiv:2306.05284",
    notes="long_500k skipped: pure full attention.  EnCodec frontend "
          "stubbed (token inputs); the slot engine does not serve it.",
))
