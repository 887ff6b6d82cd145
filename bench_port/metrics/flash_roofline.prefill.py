"""``flash_roofline.prefill``: the flash kernels' share of their bound.

The bound is the traced batches' attention operations (4·hd per live
causal (query, key) pair and head, ``bench_port/flops``) at 989 TFLOP/s;
the time is the device time of every kernel named in the program's
``flash_attention.cu``. Nothing when no such kernel ran."""
from pathlib import Path

from bench_port import peaks
from bench_port.trace import is_kernel_of, kernel_names

SOURCE = (Path(__file__).resolve().parents[2] / "src" / "repro_torch"
          / "kernels" / "flash_attention" / "csrc" / "flash_attention.cu")


def read(t):
    names = kernel_names(SOURCE)
    secs = sum(s for name, _, s in t.kernels if is_kernel_of(name, names))
    if secs == 0:
        return None
    return 100 * t.work["flash"] / peaks.PEAK_FLOPS_BF16 / secs
