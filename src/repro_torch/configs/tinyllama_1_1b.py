"""tinyllama-1.1b [arXiv:2401.02385; hf]

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000 — llama2-arch small.
"""
from repro_torch.models.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    kv_heads=4,
    d_ff=5632,
    vocab=32000,
    head_dim=64,
    norm="rms",
    act="swiglu",
    use_rope=True,
    rope_theta=10000.0,
    tie_embeddings=False,
    remat="full",
)

register(ArchSpec(
    name="tinyllama-1.1b",
    family="dense",
    config=CONFIG,
    shapes=dict(LM_SHAPES),
    long_context_ok=False,
    source="arXiv:2401.02385; hf:TinyLlama/TinyLlama-1.1B",
    notes="long_500k skipped: pure full attention.",
))
