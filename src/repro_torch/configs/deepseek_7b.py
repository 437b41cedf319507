"""deepseek-7b [arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-7b-base]

30L d_model=4096 32H (kv=32, i.e. full MHA) d_ff=11008 vocab=102400 —
llama-arch.
"""
from repro_torch.models.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    kv_heads=32,
    d_ff=11008,
    vocab=102400,
    head_dim=128,
    norm="rms",
    act="swiglu",
    use_rope=True,
    rope_theta=10000.0,
    tie_embeddings=False,
    remat="full",
)

register(ArchSpec(
    name="deepseek-7b",
    family="dense",
    config=CONFIG,
    shapes=dict(LM_SHAPES),
    long_context_ok=False,
    source="arXiv:2401.02954",
    notes="long_500k skipped: pure full attention.",
))
