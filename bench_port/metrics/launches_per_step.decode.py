"""``launches_per_step.decode``: device kernels per decode step, from
the profiler (copies and sets not counted)."""


def read(t):
    return len(t.kernels) / t.steps
