"""Whisper-medium — encoder-decoder audio backbone.  [arXiv:2212.04356]

24 encoder + 24 decoder layers, d_model=1024, 16 heads (kv=16), d_ff=4096,
vocab=51865, GeLU MLP, LayerNorm, qkv biases.  RoPE on the decoder's
self-attention and the encoder's (the repo's positional scheme); none on
cross-attention.  The mel-spectrogram + conv frontend is a stub: a request
brings 1500 precomputed frame embeddings (``audio_embeds``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,  # decoder layers; encoder_layers adds the encoder stack
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    block_pattern=("xattn+mlp",),
    encoder_layers=24,
    encoder_seq=1500,
    mlp_act="gelu",
    norm="layernorm",
    qkv_bias=True,
    citation="arXiv:2212.04356 (Whisper)",
)
