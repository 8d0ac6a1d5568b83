"""Shared models of the port's config-zoo tests (imported, not collected).

The six attention-only zoo architectures, the two recurrent ones
(:data:`REC`) and the encoder-decoder (``whisper-medium``, its encoder
stack included) at ``reduced()`` size, plus the
narrow configs that carry features no zoo config reaches at that size:
granite kept at 32 experts / top-8 / cache 8, phi-3 at head_dim 96,
tail layers and a logit softcap.  Parameters are drawn once per module
with numpy from a seed, in the reference's layout (the leaves and shapes
of its ``init_model``, found by ``jax.eval_shape``, with its init scales),
and crossed into the port by ``bridge``.  Every norm scale, norm bias and
attention bias is random too, where the reference initialises scales to
one and biases to zero, which would hide a missing term.  The recurrent
mixers' leaves follow the reference's init distributions: the RG-LRU's
``lam`` ~ U(-9, -4.3), the mLSTM's forget-bias ramp ``bf`` = linspace(3,
6) and ``bi`` = -3, the sLSTM's forget-gate bias ramp (the other gate
biases 0), with the conv bias and head norms random as above.
"""
from __future__ import annotations

import jax
import numpy as np

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config as pget

ZOO = ("granite-moe-1b-a400m", "smollm-360m", "stablelm-1.6b", "qwen1.5-4b",
       "command-r-plus-104b", "phi-3-vision-4.2b")
REC = ("recurrentgemma-9b", "xlstm-1.3b")

# granite at its published expert count, top-k and offload spec, widths
# narrowed by hand (reduced() would give 4 experts and top-2, below its
# cache of 8)
GRANITE_NARROW = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
                      head_dim=64, d_ff=64, vocab_size=512, dtype="float32")
# phi-3 at its published head_dim 96: 2 heads x 96
PHI3_HD96 = dict(n_layers=2, d_model=192, n_heads=2, n_kv_heads=2,
                 head_dim=96, d_ff=256, vocab_size=512, num_image_tokens=4,
                 dtype="float32")
# tail layers: 3 layers of a 2-period pattern, a dense tail after an MoE
# period (the reference's packed store refuses MoE tail layers), geglu
TAIL = dict(n_layers=3, block_pattern=("attn+mlp", "swa+moe"),
            mlp_act="geglu", d_model=64, d_ff=64, n_heads=2, n_kv_heads=1)
# a logit softcap with a padded vocabulary (500 -> 512)
SOFTCAP = dict(logit_softcap=5.0, vocab_size=500)
# the published GQA ratios 3 (smollm: 15 / 5) and 12 (command-r: 96 / 8),
# which reduced() turns into 4
GQA3 = dict(n_heads=6, n_kv_heads=2, head_dim=32)
GQA12 = dict(n_heads=12, n_kv_heads=1, head_dim=32)

# name: (base config, changes, whether the changes apply to its reduced())
VARIANTS = {
    "granite-32x8": ("granite-moe-1b-a400m", GRANITE_NARROW, False),
    "phi3-hd96": ("phi-3-vision-4.2b", PHI3_HD96, False),
    "tail": ("tiny-moe", TAIL, False),
    "softcap": ("smollm-360m", SOFTCAP, True),
    "gqa3": ("smollm-360m", GQA3, True),
    "gqa12": ("command-r-plus-104b", GQA12, True),
}


def configs(name: str):
    """(reference config, port config) of a zoo name (``reduced()``) or
    of a :data:`VARIANTS` key."""
    if name in VARIANTS:
        base, kw, reduce = VARIANTS[name]
        jc, pc = jget(base), pget(base)
        if reduce:
            jc, pc = jc.reduced(), pc.reduced()
        return jc.replace(**kw), pc.replace(**kw)
    return jget(name).reduced(), pget(name).reduced()


def random_params(cfg, seed: int = 0):
    """A numpy tree in the reference's layout for ``cfg``: norm scales 1 +
    0.2 N, norm and attention biases 0.2 N, output matrices (``wo``,
    ``w_down``, ``w_out``) N / sqrt(their K * 2 n_layers), every other
    leaf N / sqrt(d_model), the reference's init scales; the recurrent
    leaves as the module docstring says."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.key(0), cfg))

    H = cfg.n_heads
    dh = cfg.d_model // H
    ramp = np.linspace(3.0, 6.0, H)
    rec_out = 1 / np.sqrt(cfg.d_model * 2 * cfg.n_layers)

    def draw(path, s):
        name = getattr(path[-1], "key", None)
        z = rng.standard_normal(s.shape)
        if name == "lam":
            z = rng.uniform(-9.0, -4.3, s.shape)
        elif name == "bf":
            z = np.broadcast_to(ramp, s.shape)
        elif name == "bi":
            z = np.full(s.shape, -3.0)
        elif name == "b_gates":
            z = np.zeros(s.shape)
            z[..., 2, :, :] = ramp[:, None]  # the forget gate
        elif name in ("scale", "headnorm"):
            z = 1 + 0.2 * z
        elif name in ("bias", "bq", "bk", "bv", "bo", "conv_b"):
            z = 0.2 * z
        elif name == "conv_w":
            z = 0.1 * z
        elif name == "r_gates":
            z = z / np.sqrt(dh)
        elif name in ("w_out_r", "out_proj"):
            z = z * rec_out
        elif name == "wo":
            z = z / np.sqrt(cfg.n_heads * cfg.head_dim * 2 * cfg.n_layers)
        elif name in ("w_down", "w_out"):
            z = z / np.sqrt(cfg.d_ff * 2 * cfg.n_layers)
        else:
            z = z / np.sqrt(cfg.d_model)
        return z.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class Models:
    """Per-name (jcfg, pcfg, reference params as jax arrays, port params),
    made on first use."""

    def __init__(self):
        self._cache = {}

    def __call__(self, name: str):
        if name not in self._cache:
            jc, pc = configs(name)
            tree = random_params(jc)
            self._cache[name] = (jc, pc, jax.tree.map(jax.numpy.asarray, tree),
                                 bridge.params_from_numpy(tree, pc, "cpu"))
        return self._cache[name]


def tokens(cfg, B: int, S: int, seed: int = 1) -> np.ndarray:
    """Seeded token ids (B, S), 0 excluded (the pad id)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)


def image_embeds(cfg, B: int, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.num_image_tokens,
                                cfg.d_model)).astype(np.float32)
