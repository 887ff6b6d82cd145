"""Tiny versions of the benchmark's cells for CPU tests: every width
cut, every rule of the cell's configuration and traffic kept."""
from bench_port import harness

CELLS = ("granite-moe-3b.prefill-4x4096", "phi4-mini-3b.decode-96x4096")
SEED = 2**31 + 12345


def tiny_spec(cell: str, **model) -> harness.Spec:
    spec = harness.load_spec(cell)
    m = spec.config["model"]
    m.update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=300)
    if m.get("moe"):
        m["moe"].update(num_experts=4, experts_per_token=2, group_size=16)
    m.update(model)
    t = spec.traffic
    if t["kind"] == "prefill":
        t.update(batch=2, prompt_len=64, sample_batches=2, trace_steps=2)
    else:
        t.update(sessions=4, prompt_len=24, cache_len=40, prefill_chunk=3,
                 sample_sessions=2,
                 sample_steps=3, trace_steps=5)
    return spec
