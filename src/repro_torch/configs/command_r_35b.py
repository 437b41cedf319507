"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01; unverified]

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 — GQA, no-bias.
Cohere specifics: parallel attention+FFN block, LayerNorm without bias,
tied embeddings with logit scaling, full RoPE.  Its 30.3B params (121
GB in fp32) fit no single card: the smoke run holds it at its widths,
cut in depth.
"""
from repro_torch.models.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=22528,
    vocab=256000,
    head_dim=128,
    norm="layer",
    act="swiglu",
    parallel_block=True,
    qkv_bias=False,
    mlp_bias=False,
    use_rope=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    logit_scale=0.0625,
    remat="full",
)

register(ArchSpec(
    name="command-r-35b",
    family="dense",
    config=CONFIG,
    shapes=dict(LM_SHAPES),
    long_context_ok=False,
    source="hf:CohereForAI/c4ai-command-r-v01 (unverified tier)",
    notes="long_500k skipped: pure full attention.",
))
