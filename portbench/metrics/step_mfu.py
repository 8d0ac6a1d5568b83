"""Model step: model operations of every prompt and output token processed
in the traced slice (attention projections, router, the top-k experts,
head; attention's scores over the keys each query sees), over the slice's
seconds times the bf16 peak (989 TFLOP/s at 700 W)."""
from portbench import work as WK
from portbench.metrics._common import share, traced


def read(run, name):
    if traced(run, "busy_s") is None or not run.trace["tokens"]:
        return None
    t = run.trace
    flops = (t["tokens"] * WK.token_matmul_flops(run.cfg)
             + WK.attention_score_flops(run.cfg, t["pairs"]))
    return share(flops / t["window_s"], WK.BF16_FLOP_PER_S)
