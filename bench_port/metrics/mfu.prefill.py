"""``mfu.prefill``: the serving prefill's share of the card's bf16 peak.

The frozen operation count of the traced batches (``bench_port/flops``)
over the traced window's seconds, over 989 TFLOP/s, in percent."""
from bench_port import peaks


def read(t):
    return 100 * t.work["total"] / t.window_s / peaks.PEAK_FLOPS_BF16
