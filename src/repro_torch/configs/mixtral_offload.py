"""The paper's deployment: Mixtral-8x7B with 2-bit experts, 4-bit
attention, k=4 LRU slots and 2 speculative loads (Eliseev & Mazur 2023,
section 3.3, the 16 GB-GPU operating point)."""
from repro_torch.configs.base import OffloadSpec
from repro_torch.configs.mixtral_8x7b import CONFIG as _MIXTRAL

CONFIG = _MIXTRAL.replace(
    name="mixtral-offload",
    offload=OffloadSpec(cache_size=4, num_speculative=2, lookahead=1,
                        expert_bits=2, attn_bits=4),
)
