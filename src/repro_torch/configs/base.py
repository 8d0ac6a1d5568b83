"""Model configuration: the port's own copy of the reference's dataclasses.

The fields, defaults and derived properties are those of the JAX
package's ``configs/base.py`` (tests compare the two field by field); the
port keeps its own copy so that nothing of the JAX package is imported.
Only what the offloaded-generation slice reads is carried over.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kind strings used in ``block_pattern``.  A block is "<mixer>+<ffn>".
MIXERS = ("attn", "swa", "xattn", "encattn", "rglru", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")


def parse_block(kind: str) -> Tuple[str, str]:
    mixer, _, ffn = kind.partition("+")
    ffn = ffn or "none"
    if mixer not in MIXERS:
        raise ValueError(f"unknown mixer {mixer!r} in block kind {kind!r}")
    if ffn not in FFNS:
        raise ValueError(f"unknown ffn {ffn!r} in block kind {kind!r}")
    return mixer, ffn


@dataclass(frozen=True)
class MoESpec:
    """Sparse mixture-of-experts FFN spec (token-level top-k routing)."""

    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_z_weight: float = 0.0


@dataclass(frozen=True)
class OffloadSpec:
    """Offloading configuration (Eliseev & Mazur 2023).

    ``cache_size`` is the per-layer LRU size k, ``num_speculative`` how
    many experts the speculative prefetcher stages, ``lookahead`` how many
    MoE layers ahead the gate guess is made.
    """

    cache_size: int = 2
    num_speculative: int = 2
    lookahead: int = 1
    expert_bits: int = 3
    attn_bits: int = 4
    staging_buffers: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    block_pattern: Tuple[str, ...] = ("attn+mlp",)
    moe: Optional[MoESpec] = None
    offload: Optional[OffloadSpec] = None
    sliding_window: Optional[int] = None
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_act: str = "swiglu"
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    encoder_layers: int = 0
    encoder_seq: int = 0
    num_image_tokens: int = 0
    rglru_conv_width: int = 4
    mlstm_chunk: int = 256
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    act_seq_shard: bool = False
    moe_dispatch_groups: int = 1
    citation: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        for k in self.block_pattern:
            parse_block(k)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128; the pad is masked in
        ``unembed``."""
        return -(-self.vocab_size // 128) * 128

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.pattern_period

    @property
    def n_tail_layers(self) -> int:
        return self.n_layers - self.n_periods * self.pattern_period

    def tail_kinds(self) -> Tuple[str, ...]:
        return self.block_pattern[: self.n_tail_layers]

    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind of every layer, in order."""
        return tuple(self.block_pattern[i % self.pattern_period]
                     for i in range(self.n_layers))

    @property
    def moe_layer_count(self) -> int:
        return sum(1 for k in self.layer_kinds() if parse_block(k)[1] == "moe")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant: same family, tiny dims (the reference's
        ``ModelConfig.reduced``)."""
        period = self.pattern_period
        n_layers = period if period >= 2 else 2
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        ratio = max(1, self.n_heads // self.n_kv_heads)
        n_kv = max(1, n_heads // ratio)
        head_dim = max(8, d_model // n_heads)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(4, self.moe.num_experts),
                top_k=min(2, self.moe.top_k))
        return self.replace(
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=512,
            moe=moe,
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else None),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 24) if self.encoder_seq else 0,
            num_image_tokens=(min(self.num_image_tokens, 8)
                              if self.num_image_tokens else 0),
            mlstm_chunk=16,
            rglru_conv_width=self.rglru_conv_width,
            dtype="float32",
        )
