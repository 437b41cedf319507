"""rwkv6-3b "Finch" [arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b]

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 — data-dependent
decay.  Head size 64 (40 heads); decay LoRA rank 64.

Runs ``long_500k``: the WKV state is O(1) per step.
"""
from repro_torch.models.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.rwkv6 import RWKVConfig
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    kv_heads=40,
    d_ff=8960,
    vocab=65536,
    head_dim=64,
    norm="layer",
    use_rope=False,
    tie_embeddings=False,
    pattern=("rwkv6",),
    rwkv=RWKVConfig(d_model=2560, d_ff=8960, head_dim=64,
                    decay_lora_rank=64),
    remat="full",
)

register(ArchSpec(
    name="rwkv6-3b",
    family="ssm",
    config=CONFIG,
    shapes=dict(LM_SHAPES),
    long_context_ok=True,
    source="arXiv:2404.05892",
    notes="attention-free; constant-memory decode state; runs long_500k.",
))
