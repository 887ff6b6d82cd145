"""``repro_torch.obs.device_time``: which profiler events count as a CUDA
source's kernels. The timing itself needs the card (``chip_smoke.py``,
``examples/probe_tune.py``); the names are read here, from the sources."""
import re
from pathlib import Path

import pytest

from repro_torch.obs.device_time import _is_kernel_of, kernel_names

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
SOURCES = {
    "hash_join/csrc/hash_probe.cu": ("probe_kernel",),
    "rglru/csrc/rglru_scan.cu": ("rglru_scan_kernel",),
    "flash_attention/csrc/flash_attention.cu": ("flash_fwd_kernel",
                                                "flash_wgmma_kernel"),
    "mlstm/csrc/mlstm_chunkwise.cu": ("mlstm_combine_kernel",
                                      "mlstm_output_kernel",
                                      "mlstm_state_kernel"),
    "decode_attention/csrc/decode_attention.cu": ("decode_combine_kernel",
                                                  "decode_scores_kernel",
                                                  "decode_weights_kernel"),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_kernel_names_of_each_source(source):
    got = kernel_names(CSRC / source)
    assert got == tuple(sorted(SOURCES[source]))


def test_every_global_function_is_named():
    """One name per ``__global__`` of every source (the segment kernels'
    14 too), so no kernel's device time goes uncounted."""
    for path in sorted(CSRC.glob("*/csrc/*.cu")):
        text = path.read_text()
        assert len(kernel_names(path)) == len(
            re.findall(r"__global__", text)), path.name


@pytest.mark.parametrize("key,names,want", [
    ("void (anonymous namespace)::probe_kernel<false>(int const*, "
     "unsigned char const*, int const*, int const*, long long, int, "
     "long long, long long, int*, int*)", ("probe_kernel",), True),
    ("mlstm_combine_kernel(float*, float const*, float const*, float*, "
     "int, int)", ("mlstm_combine_kernel",), True),
    ("void flash_wgmma_kernel<256>(CUtensorMap, CUtensorMap)",
     ("flash_fwd_kernel", "flash_wgmma_kernel"), True),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<int>, std::array<char*, 1ul> >(int, "
     "at::native::FillFunctor<int>, std::array<char*, 1ul>)",
     ("init_kernel", "tile_kernel", "probe_kernel"), False),
    ("void (anonymous namespace)::masked_probe_kernel<true>(int const*)",
     ("probe_kernel",), False),
    ("Memset (Device)", ("probe_kernel",), False),
])
def test_profiler_keys_match_by_name(key, names, want):
    assert _is_kernel_of(key, names) is want


PROBE = CSRC / "hash_join/csrc/hash_probe.cu"
KERNEL = "void (anonymous namespace)::probe_kernel<false>(int const*)"
FILL = "void at::native::vectorized_elementwise_kernel<4>(int)"


@pytest.fixture
def windows(monkeypatch):
    """Stand-in traced windows for ``device_ms``: each call of ``_window``
    returns the next of ``seen`` (what started after the marker, or None
    for a lost marker), and records the lead it was given."""
    import torch

    from repro_torch.obs import device_time

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    seen, leads = [], []

    def window(fn, reps, lead):
        leads.append(lead)
        return seen.pop(0)

    monkeypatch.setattr(device_time, "_window", window)
    return seen, leads


def test_device_ms_counts_the_kernels_after_the_marker(windows):
    from repro_torch.obs.device_time import device_ms
    seen, leads = windows
    seen.append([(KERNEL, 10.0), (FILL, 1.0)] * 5)
    got = device_ms(lambda: None, PROBE, launches=1, reps=5)
    assert got == {"device_ms": 0.01, "device_launches": 1.0,
                   "device_other_ms": 0.001, "device_windows": 1}
    assert leads == [5]


def test_device_ms_traces_again_with_a_longer_lead(windows):
    """A lost marker, then a window that lost one call's kernel, then a
    whole one: the lead doubles each time."""
    from repro_torch.obs.device_time import device_ms
    seen, leads = windows
    seen += [None, [(KERNEL, 10.0)] * 4, [(KERNEL, 20.0)] * 5]
    got = device_ms(lambda: None, PROBE, launches=1, reps=5)
    assert got["device_ms"] == 0.02 and got["device_windows"] == 3
    assert leads == [5, 10, 20]


def test_device_ms_raises_without_the_kernels(windows):
    """No fallback: windows that never show the source's kernels fail."""
    from repro_torch.obs.device_time import device_ms
    seen, _ = windows
    seen += [[(FILL, 1.0)] * 5, None, [], [(FILL, 2.0)], None, []]
    with pytest.raises(RuntimeError, match="no window with 1 launch"):
        device_ms(lambda: None, PROBE, launches=1, reps=5)


@pytest.mark.parametrize("lost", [5, 10])
def test_device_ms_refuses_a_window_short_of_the_known_launches(windows,
                                                                lost):
    """A call of two launches over five reps: a window that lost five or
    ten of its ten kernels after the marker (a multiple of the reps, so
    every call seems to launch the same) is traced again, and only the
    whole window counts."""
    from repro_torch.obs.device_time import device_ms
    seen, leads = windows
    seen += [[(KERNEL, 10.0)] * (10 - lost), [(KERNEL, 10.0)] * 10]
    got = device_ms(lambda: None, PROBE, launches=2, reps=5)
    assert got["device_ms"] == 0.02 and got["device_launches"] == 2
    assert got["device_windows"] == 2 and leads == [5, 10]


def test_device_ms_refuses_more_launches_than_known(windows):
    """A window with more of the source's kernels than the calls launch
    is no measurement of them either: it fails after the last window."""
    from repro_torch.obs.device_time import device_ms
    seen, _ = windows
    seen += [[(KERNEL, 10.0)] * 6] * 3
    with pytest.raises(RuntimeError, match="no window with 1 launch"):
        device_ms(lambda: None, PROBE, launches=1, reps=5, attempts=3)


def test_device_ms_needs_a_launch(windows):
    from repro_torch.obs.device_time import device_ms
    with pytest.raises(ValueError, match="at least 1"):
        device_ms(lambda: None, PROBE, launches=0)
