"""recurrentgemma-9b [arXiv:2402.19427]

38L d_model=4096 16H (GQA kv=1, MQA) d_ff=12288 vocab=256000 —
RG-LRU + local attention, 1 attention : 2 recurrent.

Pattern: (rglru, rglru, attn) x 12 periods + 2 leading recurrent layers
(= 38).  Local attention window 2048; GeGLU MLP; embeddings scaled by
sqrt(d) and tied to the unembedding; d_rnn (lru width) 4096.
"""
from repro_torch.models.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.rglru import RGLRUConfig
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    norm="rms",
    act="geglu",
    use_rope=True,
    rope_theta=10000.0,
    window=2048,
    embed_scale=True,
    tie_embeddings=True,
    pattern=("rglru", "rglru", "attn"),
    rglru=RGLRUConfig(d_model=4096, d_rnn=4096),
    remat="full",
)

register(ArchSpec(
    name="recurrentgemma-9b",
    family="hybrid",
    config=CONFIG,
    shapes=dict(LM_SHAPES),
    long_context_ok=True,   # windowed KV + LRU state: O(1) per step
    source="arXiv:2402.19427",
    notes="runs long_500k (windowed attention + recurrent state).",
))
