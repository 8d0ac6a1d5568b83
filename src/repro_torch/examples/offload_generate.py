"""The paper's headline demo (the port of the reference's
``examples/offload_generate.py``): interactive generation of an MoE model
whose experts do not fit in device memory, with mixed HQQ quantization
(3-bit experts, 4-bit attention), the LRU cache and speculative prefetch,
on the trained ``tiny-moe`` (trained and cached on first use); then the
cost model's projection at Mixtral-8x7B scale on the port's one measured
hardware row (``h100``).  On the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.examples.offload_generate
"""
import argparse

from repro_torch import resolve_device
from repro_torch.benchmarks.common import get_trained_tiny_moe
from repro_torch.configs import get_config
from repro_torch.configs.base import OffloadSpec
from repro_torch.core import cost_model as C
from repro_torch.core.offload_engine import OffloadEngine
from repro_torch.data.pipeline import decode_bytes, encode_text
from repro_torch.quant.hqq import tree_map


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params, cfg = get_trained_tiny_moe(device=dev)
    prompt = encode_text("import ")[None]

    print("=" * 64)
    print("ablation sweep (paper Table 2 policies), 64 tokens each")
    print("=" * 64)
    results = {}
    for label, spec in [
        ("full algorithm", OffloadSpec(cache_size=4, num_speculative=2)),
        ("w/o pre-loading", OffloadSpec(cache_size=4, num_speculative=0)),
        ("w/o LRU & pre-loading", OffloadSpec(cache_size=1,
                                              num_speculative=0)),
    ]:
        out, stats = OffloadEngine(params, cfg, spec,
                                   device=dev).generate(prompt, 64)
        results[label] = stats
        print(f"{label:26s} hit_ratio={stats.hit_ratio:.3f} "
              f"demand/tok={stats.demand_loads/stats.n_tokens:.2f} "
              f"text={decode_bytes(out[0])[:40]!r}")

    print("\nprojected tokens/s at Mixtral-8x7B scale (3-bit experts), the "
          "cost model's rows:")
    mixtral = get_config("mixtral-8x7b")
    print(f"{'policy':28s}" + "".join(f"{h:>9s}" for h in C.HARDWARE))
    for label, stats in results.items():
        print(f"{label:28s}" + "".join(
            f"{C.tokens_per_second(mixtral, hw, stats.per_token(), 3):9.2f}"
            for hw in C.HARDWARE.values()))
    print(f"{'naive offloading':28s}" + "".join(
        f"{C.tokens_per_second(mixtral, hw, C.TokenStats(0, 0, 0, 0), 3, naive=True):9.2f}"
        for hw in C.HARDWARE.values()))

    print("\nmixed quantization (3-bit experts / 4-bit attention), packed "
          "execution:")
    engq = OffloadEngine(params, cfg, quantized=True, device=dev)
    out, stats = engq.generate(prompt, 64)
    print(f"quantized generation: {decode_bytes(out[0])[:48]!r}")
    print(f"measured traffic: {stats.demand_loads} demand + "
          f"{stats.spec_loads} speculative loads x "
          f"{stats.expert_bytes/1e3:.1f}KB/expert = "
          f"{stats.bytes_h2d/1e6:.2f}MB host->device")
    print("sizes:", {k: f"{v/1e6:.2f}MB" for k, v in engq.size_report.items()})

    # where the bytes live under packed offloading against keeping the
    # dense model resident
    sizes = []
    for layer in params["layers"]:
        tree_map(lambda a: sizes.append(a.numel() * 2),
                 layer.get("moe", {}).get("experts", {}))
    dense_experts = sum(sizes)
    ps = engq._last_pool_state
    pool_b = ps.pool.nbytes() + ps.staging.nbytes()
    other_b = engq.size_report["attn"] + engq.size_report["fp16"]
    print("\nmemory footprint (measured, tiny-moe scale):")
    print(f"  dense fp16 experts, all resident : {dense_experts/1e6:8.2f}MB")
    print(f"  packed host store (off-device)   : "
          f"{engq.store.nbytes()/1e6:8.2f}MB")
    print(f"  device expert buffer pool        : {pool_b/1e6:8.2f}MB "
          f"({cfg.moe_layer_count} layers x ({engq.spec.cache_size} LRU + "
          f"{engq.spec.num_speculative} staging) slots)")
    print(f"  non-expert device weights        : {other_b/1e6:8.2f}MB")
    print(f"  => device-resident total {(pool_b+other_b)/1e6:.2f}MB vs "
          f"{(dense_experts+other_b)/1e6:.2f}MB dense-resident "
          f"({(dense_experts+other_b)/(pool_b+other_b):.1f}x)")


if __name__ == "__main__":
    main()
